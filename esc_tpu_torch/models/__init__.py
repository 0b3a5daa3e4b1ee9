from .codecs import ESC, ESCModule, make_model

__all__ = ["ESC", "ESCModule", "make_model"]
