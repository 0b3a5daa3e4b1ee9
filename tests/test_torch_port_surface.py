"""The port's public surface against ``esc_tpu``'s.

For every module of ``esc_tpu`` with an ``__all__`` (read with ``ast``, so
nothing of JAX is imported for it), each name must exist in the port's
module of the same path under ``esc_tpu_torch``, or be in :data:`MAPPED`:
a port name that exists (``module:attribute``, or a module), or ``None``,
each entry with its reason.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# (esc_tpu module, name) -> (port names, or None; the reason)
MAPPED = {
    ("esc_tpu.checkpoint", "restore_into"): (
        ["esc_tpu_torch.checkpoint:load_checkpoint",
         "esc_tpu_torch.convert:from_jax_params",
         "esc_tpu_torch.train.optim:AdamW.load_state_dict"],
        "restore_into fills flax target trees; the port reads a payload as "
        "nested dicts, carries the weights by from_jax_params and the "
        "optimizer state by AdamW.load_state_dict"),
    ("esc_tpu.convert", "flax_to_torch"): (
        ["esc_tpu_torch.convert:from_jax_params"],
        "flax parameters -> the port's torch-key state dict"),
    ("esc_tpu.convert", "torch_to_flax"): (
        ["esc_tpu_torch.convert:to_jax_params"],
        "the port's module, whose keys are the reference's torch keys, -> "
        "the flax parameter tree"),
    ("esc_tpu.convert", "load_torch_checkpoint"): (
        ["esc_tpu_torch.models.codecs:Codec.load_state_dict"],
        "a reference .pth is a torch state dict in the port's own keys: "
        "torch.load, then Codec.load_state_dict, which drops the "
        "reference's ignorable buffers"),
    ("esc_tpu.ops.stft", "hann_window"): (
        None,
        "a helper of the JAX framing; the port's window is torch's periodic "
        "Hann folded into its DFT matrix (ops/stft.py::_padded_window)"),
    ("esc_tpu.ops.stft", "frame_signal"): (
        None,
        "the port's STFT is one DFT product over frames that Tensor.unfold "
        "takes inside stft"),
    ("esc_tpu.ops.stft", "overlap_add"): (
        None,
        "the port's inverse STFT overlap-adds with F.fold inside istft"),
    ("esc_tpu.ops.pallas", "codebook_argmin"): (
        ["esc_tpu_torch.ops.kernels:codebook_argmin"],
        "the Pallas kernel's CUDA C++ port and its wrapper"),
    ("esc_tpu.ops.pallas.vq_kernels", "codebook_argmin"): (
        ["esc_tpu_torch.ops.kernels.codebook_argmin:codebook_argmin",
         "esc_tpu_torch.ops.kernels.codebook_argmin:codebook_argmin_plain"],
        "the CUDA C++ kernel's wrapper and its plain version"),
    ("esc_tpu.ops.pallas.attention_kernels", "fused_window_attention"): (
        ["esc_tpu_torch.ops.kernels.window_attention:window_attention",
         "esc_tpu_torch.ops.kernels.window_attention:"
         "window_attention_plain"],
        "the CUDA C++ kernel's wrapper and its plain version"),
    ("esc_tpu.ops.pallas.attention_kernels", "fused_attention_profitable"): (
        None,
        "a choice between the Pallas kernel and XLA by head geometry; the "
        "CUDA kernel takes every geometry of the codecs (head groups), so "
        "the port has no choice to make"),
    ("esc_tpu.parallel", "make_mesh"): (
        ["esc_tpu_torch.parallel:DataParallel",
         "esc_tpu_torch.parallel:init_distributed"],
        "one rank per card under torch.distributed in place of a device "
        "mesh"),
    ("esc_tpu.parallel", "shard_batch"): (
        ["esc_tpu_torch.parallel:DataParallel.shard"],
        "each rank takes its block of a global batch's rows"),
    ("esc_tpu.parallel", "replicate"): (
        ["esc_tpu_torch.parallel:DataParallel.replicate"],
        "rank 0's tensors broadcast to every rank"),
    ("esc_tpu.baselines.encodec.convert", "torch_to_encodec_params"): (
        ["esc_tpu_torch.baselines.encodec.convert:load_release",
         "esc_tpu_torch.baselines.encodec.model:Encodec.load_torch_weights"],
        "the port's EnCodec holds the release's torch keys, so a release "
        "state dict loads as it is, its EMA buffers dropped"),
    ("esc_tpu.baselines.encodec.convert", "load_torch_encodec"): (
        ["esc_tpu_torch.baselines.encodec.model:Encodec.load_torch_weights"],
        "a release file into the codec"),
    ("esc_tpu.native", "wavio"): (
        ["esc_tpu_torch.io"],
        "the port reads and writes RIFF WAV in Python (load_wav, save_wav), "
        "with no native library"),
}
for _name in ("make_mesh", "shard_batch", "replicate"):   # re-exported
    MAPPED["esc_tpu.parallel.mesh", _name] = MAPPED["esc_tpu.parallel", _name]


def _public_names(path: Path):
    """The names of a module's ``__all__``, or None."""
    for node in ast.parse(path.read_text()).body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == "__all__"
               for t in targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    return None


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


PUBLIC = {_module_name(p): names
          for p in sorted((ROOT / "esc_tpu").rglob("*.py"))
          if (names := _public_names(p)) is not None}


def _resolve(spec: str):
    """``"pkg.module:Attr.attr"`` (or a module) -> the object."""
    module, _, attrs = spec.partition(":")
    obj = importlib.import_module(module)
    for attr in filter(None, attrs.split(".")):
        obj = getattr(obj, attr)
    return obj


@pytest.mark.parametrize("module", sorted(PUBLIC))
def test_every_public_name_has_a_counterpart(module):
    port_name = "esc_tpu_torch" + module[len("esc_tpu"):]
    try:
        port = importlib.import_module(port_name)
    except ModuleNotFoundError:
        port = None
    missing = []
    for name in PUBLIC[module]:
        if (module, name) in MAPPED:
            targets, reason = MAPPED[module, name]
            assert reason, (module, name)
            for spec in targets or []:
                assert _resolve(spec) is not None, spec
        elif port is None or not hasattr(port, name):
            missing.append(name)
    assert not missing, f"{port_name} lacks {missing}"


def test_every_mapping_is_of_a_public_name():
    assert len(PUBLIC) > 40
    for module, name in MAPPED:
        assert name in PUBLIC.get(module, ()), (module, name)
