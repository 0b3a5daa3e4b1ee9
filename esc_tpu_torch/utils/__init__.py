"""Config helpers and the device -> host transfer."""

from .config import dict2namespace, namespace2dict, read_yaml
from .host import to_host

__all__ = ["read_yaml", "dict2namespace", "namespace2dict", "to_host"]
