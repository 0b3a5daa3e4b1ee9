"""The port's EnCodec baseline against the JAX package's and the release
mirror, at ``tests/test_encodec.py``'s ``SMALL`` size.

The mirror's release-key state dict (``tests/torch_mirror_encodec.py``)
loads into the port as it is and into the JAX package through its
converter, against the zeros of ``jax.eval_shape``'s tree, so that no JAX
init compiles. Bars: codes bit-exact at every ``n_q`` (encode and the
forward); latents within 1e-5; waveforms decoded from the same codes, the
forward's and the 16 kHz wrapper's within 1e-4; the training forward's
commitment loss within rtol 5e-4 and each gradient leaf's cosine above
0.995 (``tests/test_torch_port_train.py``'s bars); the weights carried to
the flax tree and back bit for bit; a release file, EMA buffers and
``best_state`` included, loads strictly and gives the mirror's codes; at
full width, without JAX, the port's 156 keys and shapes are the mirror's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.baselines.encodec import Encodec as JaxEncodec
from esc_tpu.baselines.encodec import layers as jax_layers
from esc_tpu.baselines.encodec.convert import torch_to_encodec_params
from esc_tpu_torch.baselines.encodec import Encodec
from esc_tpu_torch.baselines.encodec import layers
from esc_tpu_torch.baselines.encodec.convert import (EMA_BUFFERS,
                                                     from_jax_params,
                                                     to_jax_params)
from tests.test_encodec import SMALL
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401
from tests.torch_mirror_encodec import EncodecMirror

L = 64


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def models():
    """(mirror, JAX Encodec, port Encodec) with the mirror's weights."""
    torch.manual_seed(0)
    mirror = EncodecMirror(**SMALL, lstm=2).eval()
    ref = JaxEncodec(bandwidth=96.0, **SMALL)
    shapes = jax.eval_shape(lambda: ref.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, L)), None, False))
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    ref.variables = torch_to_encodec_params(sd, ref.module, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = Encodec(bandwidth=96.0, device="cpu", **SMALL)
    port.load_state_dict(mirror.state_dict())
    return mirror, ref, port


@functools.lru_cache(maxsize=None)
def _jax_fn(module, what, n_q=None):
    """A jitted method of ``module`` with the variables as an argument
    (closed over, XLA would fold them into constants)."""
    if what == "latents":
        return jax.jit(lambda v, x: module.apply(
            v, x[..., None], method=lambda m, y: m.encoder(y)))
    if what == "encode":
        return jax.jit(lambda v, x: module.apply(v, x, n_q,
                                                 method="encode"))
    if what == "decode":
        return jax.jit(lambda v, c: module.apply(v, c, method="decode"))
    return jax.jit(lambda v, x: module.apply(v, x, n_q, False))


def _audio(rng, n=2, length=L):
    return (0.3 * rng.standard_normal((n, length))).astype(np.float32)


def test_weights_carry_both_ways(models):
    _, ref, port = models
    ours = dict(_flat(to_jax_params(port.state_dict())))
    theirs = dict(_flat(jax.tree.map(np.asarray, ref.variables["params"])))
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        assert ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg="/".join(k))
    back = from_jax_params(ref.variables)
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("n_q", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [L, 5], ids=["64", "short"])
def test_codes_bit_exact_at_every_n_q(models, rng, n_q, length):
    """Encode and the forward, and the latents; 5 samples reach every
    reflect pad's zero-extension guard."""
    mirror, ref, port = models
    x = _audio(rng, length=length)
    xt = torch.from_numpy(x)
    codes = port.module.encode(xt, n_q)
    assert codes.dtype == torch.int32 and codes.shape[:2] == (2, n_q)
    theirs = np.asarray(_jax_fn(ref.module, "encode", n_q)(
        ref.variables, x))
    np.testing.assert_array_equal(codes.numpy(), theirs)
    np.testing.assert_array_equal(codes.numpy(), mirror.encode(xt, n_q))
    with torch.no_grad():
        out = port.module(xt, n_q)
    want = jax.tree.map(np.asarray, _jax_fn(ref.module, "forward", n_q)(
        ref.variables, x))
    np.testing.assert_array_equal(out["codes"].numpy(), want["codes"])
    np.testing.assert_allclose(out["audio"].numpy(), want["audio"],
                               atol=1e-4)
    assert out["audio"].shape == (2, length)
    with torch.no_grad():
        z = port.module.encoder(xt[:, None])
    np.testing.assert_allclose(z.numpy().transpose(0, 2, 1), np.asarray(
        _jax_fn(ref.module, "latents")(ref.variables, x)), atol=1e-5)


def test_same_codes_decode_alike(models, rng):
    mirror, ref, port = models
    codes = rng.integers(0, SMALL["bins"], (2, SMALL["n_q"], 16)).astype(
        np.int32)
    ours = port.decode(codes).numpy()
    assert ours.shape == (2, 16 * port.module.hop_length)
    np.testing.assert_allclose(ours, np.asarray(_jax_fn(
        ref.module, "decode")(ref.variables, codes)), atol=1e-4)
    np.testing.assert_allclose(ours, mirror.decode(
        torch.from_numpy(codes).long()).numpy(), atol=1e-4)


@pytest.mark.parametrize("bandwidth", [24.0, 96.0])
def test_wrapper_at_16khz_matches(models, rng, bandwidth):
    _, ref, port = models
    ref.set_target_bandwidth(bandwidth)
    port.set_target_bandwidth(bandwidth)
    assert port.n_q == ref.n_q
    x = (0.1 * rng.standard_normal((2, 1600))).astype(np.float32)
    ours = port(x, sample_rate=16000).numpy()
    assert ours.shape == x.shape
    np.testing.assert_allclose(ours, ref(x, sample_rate=16000), atol=1e-4)
    # and at 24 kHz, with no resampling
    np.testing.assert_allclose(port(x).numpy(), ref(x), atol=1e-4)
    np.testing.assert_array_equal(port.encode(x).numpy(), ref.encode(x))


def test_bandwidth_rule_and_its_errors():
    """24 kHz at full width: 750 bps per codebook."""
    port = Encodec(bandwidth=6.0, device="cpu")
    ref = JaxEncodec(bandwidth=6.0)
    for kbps, n_q in ((1.5, 2), (3.0, 4), (6.0, 8), (12.0, 16), (24.0, 32)):
        port.set_target_bandwidth(kbps)
        ref.set_target_bandwidth(kbps)
        assert port.n_q == ref.n_q == n_q and port.bandwidth == kbps
    with pytest.raises(ValueError, match="48"):
        port.set_target_bandwidth(48.0)
    assert port.n_q == 32                     # left as it was
    with pytest.raises(ValueError, match="24 kHz"):
        Encodec(sample_rate=16000, device="cpu")


def test_training_forward_loss_and_gradients(models, rng):
    _, ref, port = models
    x = _audio(rng)
    n_q = SMALL["n_q"]

    def jax_loss(params):
        out = ref.module.apply({"params": params}, jnp.asarray(x), n_q,
                               True)
        return (jnp.mean((out["audio"] - x) ** 2)
                + jnp.mean(out["vq/commitment_loss"]),
                out["vq/commitment_loss"])

    (_, want_commit), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(ref.variables["params"])
    module = port.module
    module.zero_grad()
    out = module(torch.from_numpy(x), n_q, training=True)
    loss = ((out["audio"] - torch.from_numpy(x)) ** 2).mean() \
        + out["vq/commitment_loss"].mean()
    loss.backward()
    np.testing.assert_allclose(out["vq/commitment_loss"].detach().numpy(),
                               np.asarray(want_commit), rtol=5e-4)
    theirs = from_jax_params(jax.tree.map(np.asarray, grads))
    zero = []
    for name, p in module.named_parameters():
        a = np.zeros(p.numel(), np.float32) if p.grad is None \
            else p.grad.numpy().ravel()
        b = theirs[name].numpy().ravel()
        if not b.any():
            # the last stage's codebook: straight through in zq, detached in
            # its commitment term
            assert not a.any(), name
            zero.append(name)
            continue
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.995, name
    assert zero == [f"quantizer.vq.layers.{n_q - 1}._codebook.embed"]
    module.zero_grad()


def test_release_file_loads_strictly(models, rng, tmp_path):
    mirror, _, _ = models
    sd = dict(mirror.state_dict())
    for q in range(SMALL["n_q"]):
        pre = f"quantizer.vq.layers.{q}."
        sd[pre + "_codebook.inited"] = torch.ones(1)
        sd[pre + "_codebook.cluster_size"] = torch.rand(SMALL["bins"])
        sd[pre + "_codebook.embed_avg"] = torch.randn(SMALL["bins"],
                                                      SMALL["dimension"])
    assert sum(k.endswith(EMA_BUFFERS) for k in sd) == 3 * SMALL["n_q"]
    path = tmp_path / "encodec_24khz.th"
    torch.save({"best_state": sd}, path)
    port = Encodec(bandwidth=96.0, seed=5, device="cpu", **SMALL)
    port.load_torch_weights(str(path))
    x = torch.from_numpy(_audio(rng))
    np.testing.assert_array_equal(port.encode(x).numpy(),
                                  mirror.encode(x, SMALL["n_q"]).numpy())
    # a plain state dict loads too; a key the port lacks does not
    torch.save(mirror.state_dict(), tmp_path / "plain.th")
    port.load_torch_weights(str(tmp_path / "plain.th"))
    torch.save({**mirror.state_dict(), "extra.weight": torch.ones(1)},
               tmp_path / "bad.th")
    with pytest.raises(RuntimeError, match="extra.weight"):
        port.load_torch_weights(str(tmp_path / "bad.th"))


def test_full_width_keys_are_the_releases():
    ours = Encodec(device="cpu").state_dict()
    theirs = EncodecMirror().state_dict()
    assert len(ours) == len(theirs) == 156
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    for key in ("encoder.model.0.conv.conv.weight_v",
                "encoder.model.1.block.1.conv.conv.weight_g",
                "decoder.model.3.convtr.convtr.weight_v",
                "encoder.model.13.lstm.weight_ih_l0",
                "quantizer.vq.layers.31._codebook.embed"):
        assert key in ours
    assert sum(v.numel() for v in ours.values()) == 19046114


def test_seeded_init_is_reproducible_and_as_esc_tpus():
    a = Encodec(seed=3, device="cpu", **SMALL).state_dict()
    b = Encodec(seed=3, device="cpu", **SMALL).state_dict()
    c = Encodec(seed=4, device="cpu", **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.model.0.conv.conv.weight_v"],
                           c["encoder.model.0.conv.conv.weight_v"])
    assert all(bool((v == 1).all()) for k, v in a.items()
               if k.endswith("weight_g"))
    assert all(not v.any() for k, v in a.items()
               if k.endswith("conv.bias") or k.endswith("convtr.bias"))
    k = 1 / np.sqrt(16)       # the LSTMs' hidden size at SMALL, two each side
    lstm = [v for n, v in a.items() if ".lstm." in n]
    assert len(lstm) == 16 and all(float(v.abs().max()) <= k for v in lstm)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length", [12, 3])
def test_layers_match_esc_tpus(rng, causal, length):
    """SConv1d (dilated, strided), SConvTranspose1d and the residual unit
    with a true skip, causal or not, at a length the pad guard reaches."""
    def flax_conv(conv, transposed=False):
        inner = "ConvTranspose_0" if transposed else "Conv_0"
        return {inner: {"kernel": conv.weight_v.detach().numpy().transpose(
                    2, 1, 0), "bias": conv.bias.detach().numpy()},
                "conv": {f"{inner}/kernel/scale":
                         conv.weight_g.detach().numpy().reshape(-1)}}

    def randomize(module):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(
                    p.shape).astype(np.float32)))
        return module

    x = rng.standard_normal((2, 6, length)).astype(np.float32)
    cases = [
        (layers.SConv1d(6, 5, 3, dilation=2, causal=causal),
         jax_layers.SConv1d(5, 3, dilation=2, causal=causal),
         lambda m: flax_conv(m.conv.conv)),
        (layers.SConv1d(6, 5, 4, stride=2, causal=causal),
         jax_layers.SConv1d(5, 4, stride=2, causal=causal),
         lambda m: flax_conv(m.conv.conv)),
        (layers.SConvTranspose1d(6, 4, 5, stride=2, causal=causal),
         jax_layers.SConvTranspose1d(4, 5, stride=2, causal=causal),
         lambda m: flax_conv(m.convtr.convtr, transposed=True)),
        (layers.SEANetResnetBlock(6, causal=causal, true_skip=True),
         jax_layers.SEANetResnetBlock(6, causal=causal, true_skip=True),
         lambda m: {"block_0": flax_conv(m.block[1].conv.conv),
                    "block_1": flax_conv(m.block[3].conv.conv)}),
    ]
    for ours, theirs, params in cases:
        randomize(ours)
        with torch.no_grad():
            got = ours(torch.from_numpy(x)).numpy()
        want = np.asarray(theirs.apply({"params": params(ours)},
                                       jnp.asarray(x.transpose(0, 2, 1))))
        np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=1e-4,
                                   err_msg=type(ours).__name__)
