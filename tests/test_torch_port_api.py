"""The rest of ``esc_tpu``'s public API in the port, against ``esc_tpu``:
the standalone ``ResidualVectorQuantize`` (its own framing of a latent),
the loss classes, ``make_optimizer``, the namespace helpers and both
``download_data_hf``.

RVQ weights are drawn from a numpy seed into the flax module's own tree
(``jax.eval_shape`` of its init) and carried into the port by
``from_jax_params``. Bars: codes bit-exact; ``z_q`` within atol 5e-4 (the
waveform bar of ``tests/test_torch_parity_rvq.py``), the per-sample losses
within rtol 5e-4 (``tests/test_torch_port_train.py``'s loss bar); the
complex-STFT loss class within rtol 1e-5 and the mel loss class within
rtol 5e-4 (the same file's bars for those functions); one clipped AdamW
step within atol 1e-6 of optax's (that file's optimizer bar), the count
and the state's layout equal.
"""

import argparse
import io
import sys
import tarfile
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esc_tpu.modules.losses import ComplexSTFTLoss as JaxComplexSTFTLoss
from esc_tpu.modules.losses import MelSpectrogramLoss as JaxMelLoss
from esc_tpu.modules.vq import ResidualVectorQuantize as JaxRVQ
from esc_tpu.train import data as jax_data
from esc_tpu.train.optim import make_optimizer as jax_make_optimizer
from esc_tpu.utils import config as jax_config
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.modules.losses import ComplexSTFTLoss, MelSpectrogramLoss
from esc_tpu_torch.modules.vq import ResidualVectorQuantize
from esc_tpu_torch.train import data as port_data
from esc_tpu_torch.train.optim import AdamW, make_optimizer
from esc_tpu_torch.utils import config as port_config
from esc_tpu_torch.utils import to_host
from tests.test_torch_port_conv import draw_variables
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

# (constructor keywords, latent layout, frames W): a small width with a
# projection, one whose hidden width is the codebook's (no projection), and
# the JAX class's defaults (6 x 64 x overlap 4 = 1,536 projected to 8)
GEOMETRIES = {
    "small": (dict(in_dim=4, in_freq=3, overlap=2, codebook_size=32), 3, 8),
    "no_proj": (dict(in_dim=2, in_freq=2, overlap=2, codebook_dim=8,
                     codebook_size=16), 4, 6),
    "defaults": ({}, 3, 8),
}
Z_ATOL, LOSS_RTOL = 5e-4, 5e-4


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def rvq_pair(request):
    """(JAX module, its variables, port module, a latent) with the same
    drawn weights."""
    kw, dims, W = GEOMETRIES[request.param]
    ref = JaxRVQ(**kw)
    rng = np.random.default_rng(31)
    B, H, C = 2, ref.in_freq, ref.in_dim
    shape = (B, H * W, C) if dims == 3 else (B, C, H, W)
    z = rng.standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda r, x: ref.init(r, x, 6, False, False),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct(shape, jnp.float32))
    variables = draw_variables(shapes, rng)
    port = ResidualVectorQuantize(**kw)
    port.load_state_dict(from_jax_params(variables))
    assert port.do_proj == ref.do_proj == (request.param != "no_proj")
    assert port.hidden_dim == ref._hidden and port.fix_dim == ref.fix_dim
    return ref, variables, port.eval(), z


@pytest.mark.parametrize("freeze", [False, True], ids=["main", "freeze"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_rvq_forward_matches(rvq_pair, training, freeze):
    ref, variables, port, z = rvq_pair
    port.train(training)
    try:
        for ns in range(1, 7):
            theirs = ref.apply(variables, jnp.asarray(z), ns, freeze,
                               training)
            ours = port(torch.from_numpy(z), ns, freeze)
            np.testing.assert_array_equal(ours["codes"].numpy(),
                                          np.asarray(theirs["codes"]))
            assert ours["codes"].shape[1] == 6
            np.testing.assert_allclose(ours["z_q"].detach().numpy(),
                                       np.asarray(theirs["z_q"]), rtol=0,
                                       atol=Z_ATOL, err_msg=ns)
            assert ours["z_q"].shape == z.shape
            for k in ("cb_loss", "cm_loss"):
                a, b = ours[k].detach().numpy(), np.asarray(theirs[k])
                assert a.shape == b.shape == (z.shape[0],), k
                if freeze:
                    assert np.all(a == 0.0) and np.all(b == 0.0), k
                else:
                    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL,
                                               atol=1e-7, err_msg=(k, ns))
    finally:
        port.eval()


@pytest.mark.parametrize("ns", range(1, 7))
def test_rvq_encode_and_decode_match(rvq_pair, ns):
    ref, variables, port, z = rvq_pair
    theirs = np.array(ref.apply(variables, jnp.asarray(z), ns,
                                method="encode"))
    ours = port.encode(torch.from_numpy(z), ns)
    assert ours.dtype == torch.int32 and ours.shape[1] == ns
    np.testing.assert_array_equal(ours.numpy(), theirs)
    dims = z.ndim
    back = np.asarray(ref.apply(variables, jnp.asarray(theirs), dims,
                                method="decode"))
    mine = port.decode(torch.from_numpy(theirs), dims).detach().numpy()
    assert mine.shape == back.shape == z.shape
    np.testing.assert_allclose(mine, back, rtol=0, atol=Z_ATOL)


def test_rvq_defaults_are_the_jax_class_defaults():
    ref, port = JaxRVQ(), ResidualVectorQuantize()
    for name in ("in_dim", "in_freq", "overlap", "fix_dim", "do_proj"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.hidden_dim == ref._hidden == 1536
    assert len(port.vqs) == ref.num_vqs == 6
    assert port.vqs[0].embedding.weight.shape == (1024, 8)
    assert port.proj_down.weight.shape == (8, 1536)


# ------------------------------------------------------------ the losses
@pytest.mark.parametrize("weight,power", [(1.0, True), (0.5, False)])
def test_complex_stft_loss_class_matches(rng, weight, power):
    raw = rng.standard_normal((2, 2, 24, 30)).astype(np.float32)
    rec = (raw + 0.1 * rng.standard_normal(raw.shape)).astype(np.float32)
    ours = ComplexSTFTLoss(weight, power)(torch.from_numpy(raw),
                                          torch.from_numpy(rec))
    theirs = JaxComplexSTFTLoss(weight, power)(jnp.asarray(raw),
                                               jnp.asarray(rec))
    assert ours.shape == (2,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5)


@pytest.mark.parametrize("weight,clamp_eps", [(1.0, 1e-5), (0.25, 1e-3)])
def test_mel_spectrogram_loss_class_matches(rng, weight, clamp_eps):
    raw = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    rec = (raw + 0.01 * rng.standard_normal(raw.shape)).astype(np.float32)
    ours = MelSpectrogramLoss(weight, clamp_eps)(torch.from_numpy(raw),
                                                 torch.from_numpy(rec))
    theirs = JaxMelLoss(weight, clamp_eps)(jnp.asarray(raw),
                                           jnp.asarray(rec))
    assert ours.shape == (2,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=5e-4)


# ---------------------------------------------------------- the optimizer
@pytest.mark.parametrize("clip_norm", [0.5, None], ids=["clip", "no_clip"])
def test_make_optimizer_step_matches_optax(rng, clip_norm):
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((11,)).astype(np.float32)}
    grads = {k: (10.0 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
    tx = jax_make_optimizer(1e-3, clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
    jp = optax.apply_updates(jp, updates)
    ours = {k: torch.tensor(v) for k, v in params.items()}
    opt = make_optimizer(ours.items(), 1e-3, clip_norm=clip_norm)
    assert isinstance(opt, AdamW) and opt.clip_norm == clip_norm
    for k, p in ours.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k in params:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    theirs = jax.tree.map(np.asarray, state)
    adam = theirs[1][0] if clip_norm is not None else theirs[0]
    assert opt.count == int(adam.count) == 1
    layout = opt.state_dict()
    assert set(layout) == ({"0", "1"} if clip_norm is not None
                           else {"0", "1", "2"})


# ------------------------------------------------------ namespace helpers
def test_namespace_helpers_round_trip_as_jax_does():
    cfg = {"data": {"train_bs_per_device": 9, "paths": ["a", "b"]},
           "model_name": "csvq+swinT",
           "model": {"h_dims": [45, 72], "nested": {"x": 1.5, "y": None}},
           "loss": {}}
    ours, theirs = port_config.dict2namespace(cfg), \
        jax_config.dict2namespace(cfg)
    assert isinstance(ours, argparse.Namespace)
    assert ours == theirs
    assert ours.model.nested.x == 1.5 and ours.loss == argparse.Namespace()
    assert port_config.namespace2dict(ours) == \
        jax_config.namespace2dict(theirs) == cfg
    assert port_config.namespace2dict(3) == jax_config.namespace2dict(3) == 3


def test_to_host_passes_arrays_and_reads_tensors():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert to_host(x) is x
    t = torch.from_numpy(x).requires_grad_(True) * 2
    np.testing.assert_array_equal(to_host(t), 2 * x)
    np.testing.assert_array_equal(to_host([1, 2]), np.array([1, 2]))


# ------------------------------------------------------- download_data_hf
def _fake_hub(monkeypatch, tar_path):
    """A ``huggingface_hub`` in ``sys.modules`` whose download returns
    ``tar_path`` and records its arguments."""
    calls = []

    def hf_hub_download(repo_id, filename, repo_type, local_dir):
        calls.append(dict(repo_id=repo_id, filename=filename,
                          repo_type=repo_type, local_dir=local_dir))
        return str(tar_path)

    fake = types.ModuleType("huggingface_hub")
    fake.hf_hub_download = hf_hub_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    return calls


@pytest.fixture
def tarball(tmp_path):
    wav = tmp_path / "clip.wav"
    port_data.save_wav(str(wav), np.zeros(1600, np.float32))
    path = tmp_path / "testset.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        tf.add(wav, arcname="testset/clip.wav")
    return path


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def _run(fn, *args, **kwargs):
    out = io.StringIO()
    with redirect_stdout(out):
        path = fn(*args, **kwargs)
    return path, out.getvalue()


@pytest.mark.parametrize("module", ["utils.config", "train.data"])
@pytest.mark.parametrize("args", [(), ("org/dnscustom", "testset.tar.gz")],
                         ids=["defaults", "given"])
def test_download_data_hf_matches_with_a_fake_hub(monkeypatch, tmp_path,
                                                  tarball, module, args):
    ours_fn, theirs_fn = {
        "utils.config": (port_config.download_data_hf,
                         jax_config.download_data_hf),
        "train.data": (port_data.download_data_hf,
                       jax_data.download_data_hf)}[module]
    calls = _fake_hub(monkeypatch, tarball)
    extract = {"extract": True} if module == "train.data" else {}
    results = []
    for side, fn in (("ours", ours_fn), ("theirs", theirs_fn)):
        local = tmp_path / side
        results.append(_run(fn, *args, local_dir=str(local), **extract))
        if extract:
            assert (local / "testset" / "clip.wav").exists()
    (ours, ours_said), (theirs, theirs_said) = results
    assert ours == theirs == str(tarball)
    assert ours_said == theirs_said.replace(str(tmp_path / "theirs"),
                                            str(tmp_path / "ours"))
    assert f"located at {tarball}" in ours_said
    assert len(calls) == 2
    assert calls[0] == dict(calls[1], local_dir=str(tmp_path / "ours"))
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs")


@pytest.mark.parametrize("module", ["utils.config", "train.data"])
def test_download_data_hf_without_the_hub_raises_as_jax_does(monkeypatch,
                                                             module):
    ours_fn, theirs_fn = {
        "utils.config": (port_config.download_data_hf,
                         jax_config.download_data_hf),
        "train.data": (port_data.download_data_hf,
                       jax_data.download_data_hf)}[module]
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(Exception) as theirs:
        theirs_fn()
    with pytest.raises(type(theirs.value)) as ours:
        ours_fn()
    assert type(ours.value) is type(theirs.value)
    assert "huggingface_hub" in str(ours.value)
