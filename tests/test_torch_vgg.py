"""The port's LibriSpeech VGG model against the JAX package on the CPU:
the spatial conv and pool ops, the encoder, the training forward and
its gradients, K8's plain version with VGG's four-layer readout, the
beam, and K2's plain version at a vocabulary wider than one block of
the card held before K2 spread it over its cluster.

Tolerances (the JAX package's parity tolerances): float32 forward rtol
2e-5 (atol 2e-6), gradients rtol 5e-4 (atol 5e-6); beam tokens and
lengths identical, scores rtol 1e-5 (atol 1e-5). VGGConfig has no backend options,
so the JAX model's decoder scan and beam take XLA on the CPU; K8's and
K2's plain versions are held to the Pallas step kernel in interpret
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.models import vgg as jvgg
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops import conv as jconv
from seq2seq_attention_asr_tpu.ops.pallas import attention_step as jstep
from seq2seq_attention_asr_tpu.train import experiment as jexperiment
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.models import registry, vgg
from seq2seq_attention_asr_tpu_torch.ops import attention, conv
from seq2seq_attention_asr_tpu_torch.ops.cuda import attention_step
from seq2seq_attention_asr_tpu_torch.train import experiment

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-6
# 20 frequency bins give freq' = 2 after the two pools: fc1 takes 256 features.
DIMS = dict(input_frame_size=20, output_frame_size=16, score_depth=12, state_depth=12,
            mlp_depth=8, output_depth=9)


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape,kernel,pools", [
    ((2, 11, 9, 3), (3, 3, 3, 5), [(1, 2, 1, 2), (2, 2, 2, 2)]),
    ((3, 8, 12, 4), (2, 3, 4, 2), [(2, 2, 2, 2), (3, 1, 2, 1)]),
    ((1, 5, 4, 2), (3, 2, 2, 3), [(1, 2, 1, 2), (2, 3, 1, 1)]),
    ((2, 2, 6, 3), (3, 3, 3, 4), [(1, 2, 1, 2)]),  # H under the kernel's: no output row
])
def test_spatial_conv_and_pool(shape, kernel, pools):
    """VALID NHWC conv (HWIO kernel) and max pools at odd shapes, values
    and gradients (of sum(out * cot) for the input and the weights)."""
    kh, kw, c_in, c_out = kernel
    rng = np.random.RandomState(sum(shape))
    p = jax.tree.map(np.asarray, jconv.spatial_conv_init(jax.random.PRNGKey(kh), c_in, c_out,
                                                         kh, kw))
    x = rng.randn(*shape[:3], c_in).astype(np.float32)
    want = jconv.spatial_conv(p, jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), port(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = conv.spatial_conv(tp, tx)
    assert got.shape == want.shape
    close(got.detach(), want)
    if got.numel():
        cot = rng.randn(*got.shape).astype(np.float32)
        wgp, wgx = jax.grad(lambda pp, xx: jnp.sum(jconv.spatial_conv(pp, xx) * cot),
                            argnums=(0, 1))(p, jnp.asarray(x))
        gw, gb, gx = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                         [tp["w"], tp["b"], tx])
        close(gw, wgp["w"], GRAD_RTOL, GRAD_ATOL)
        close(gb, wgp["b"], GRAD_RTOL, GRAD_ATOL)
        close(gx, wgx, GRAD_RTOL, GRAD_ATOL)
    for ph, pw, sh, sw in pools:
        want = jconv.spatial_max_pool(jnp.asarray(x), ph, pw, sh, sw)
        tx = torch.from_numpy(x).requires_grad_(True)
        got = conv.spatial_max_pool(tx, ph, pw, sh, sw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        if got.numel():
            cot = rng.randn(*got.shape).astype(np.float32)
            wgx = jax.grad(lambda xx: jnp.sum(jconv.spatial_max_pool(xx, ph, pw, sh, sw)
                                              * cot))(jnp.asarray(x))
            gx, = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), [tx])
            np.testing.assert_array_equal(gx.numpy(), np.asarray(wgx))


@pytest.fixture(scope="module")
def models():
    jmodel = jregistry.build("vgg", **DIMS)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, registry.build("vgg", **DIMS), params


def test_config_and_init_have_the_jax_tree(models):
    jmodel, pmodel, params = models
    assert pmodel.cfg.collapsed_freq == jmodel.cfg.collapsed_freq == 256
    assert pmodel.cfg.annotation_depth == jmodel.cfg.annotation_depth == 16
    assert pmodel.attention_cfg.readout == jmodel.attention_cfg.readout
    got = interop.to_numpy(pmodel.init(torch.Generator().manual_seed(1), device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(params)]
    assert registry.build("vgg", compute_dtype="bfloat16").cfg.compute_dtype == "bfloat16"
    with pytest.raises(ValueError):
        registry.build("vgg", compute_dtype="float16")


def _batch(seed, b=6, l=30):
    """Stacked features (B, L, 20, 3) zero past each row's length, the
    lengths ragged, one of them under the encoder's 8 frames."""
    rng = np.random.RandomState(seed)
    lens = np.array([30, 23, 5, 17, 30, 11][:b], np.int32)
    x = rng.randn(b, l, 20, 3).astype(np.float32)
    x *= (np.arange(l)[None, :, None, None] < lens[:, None, None, None])
    return x, lens


def test_encode_matches_jax(models):
    jmodel, pmodel, params = models
    x, lens = _batch(1)
    want, want_len = jvgg.encode(params, jmodel.cfg, jnp.asarray(x), jnp.asarray(lens))
    got, got_len = pmodel.encode(port(params), torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == want.shape == (6, 11, 16)
    close(got, want)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.tolist() == [11, 7, 0, 4, 11, 1]


def _objective(out, oh, dm):
    nll = -(oh * out["logprobs"] * dm[..., None]).sum()
    return nll + 0.1 * (out["alpha"] ** 2).sum()


def test_forward_and_gradients_match_jax(models):
    """The training forward on ragged lengths (a row with no encoder
    frame: its alpha and context are 0), and the gradient of nll + 0.1 *
    sum(alpha^2) for every weight and the input."""
    jmodel, pmodel, params = models
    x, lens = _batch(2)
    rng = np.random.RandomState(3)
    t = 7
    dm = (np.arange(t)[None] < np.array([7, 4, 2, 7, 5, 3])[:, None]).astype(np.float32)
    oh = np.eye(9, dtype=np.float32)[rng.randint(0, 9, (6, t))] * dm[..., None]

    def jloss_fn(p, xx):
        out = jvgg.forward(p, jmodel.cfg, xx, *map(jnp.asarray, (lens, oh, dm)), train=True)
        return _objective(out, oh, dm), out

    (_, want), (wgp, wgx) = jax.value_and_grad(jloss_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tp = jax.tree.map(lambda a: a.requires_grad_(True), port(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = pmodel.forward(tp, tx, *map(torch.from_numpy, (lens, oh, dm)), train=True)
    assert got["alpha"].shape == (6, t, 11)
    for key in ("logprobs", "alpha", "penalty"):
        close(got[key].detach(), want[key])
    assert not got["alpha"][2].any()
    grads = torch.autograd.grad(_objective(got, torch.from_numpy(oh), torch.from_numpy(dm)),
                                jax.tree.leaves(tp) + [tx])
    for g, w in zip(grads, jax.tree.leaves(wgp) + [wgx]):
        close(g, w, GRAD_RTOL, GRAD_ATOL)


def _step_inputs(jcfg, params, b, k, l, seed):
    rng = np.random.RandomState(seed)
    v, st, a = jcfg.output_depth, jcfg.state_depth, jcfg.annotation_depth
    h = rng.randn(b, l, a).astype(np.float32)
    lens = rng.randint(1, l + 1, b)
    mask = (np.arange(l)[None] < lens[:, None]).astype(np.float32)
    alpha0 = rng.rand(b, k, l).astype(np.float32)
    s0 = (rng.randn(b, k, st) * 0.3).astype(np.float32)
    y = np.eye(v, dtype=np.float32)[rng.randint(0, v, (b, k))]
    vh = np.asarray(jatt.precompute_vh(params, jnp.asarray(h)))
    return alpha0, s0, np.zeros_like(s0), y, vh, h, mask


def _step_parity(jcfg, cfg, params, b, k, l, seed, route):
    """fused_attention_step's plain version (the wrapper on CPU tensors)
    against the JAX Pallas step kernel in interpret mode, readout fused."""
    assert attention_step.uses_k2(cfg) == (route == "K2")
    alpha0, s0, mem0, y, vh, h, mask = _step_inputs(jcfg, params, b, k, l, seed)
    (wa, ws, wm), want = jstep.fused_attention_step(
        params, jcfg, tuple(map(jnp.asarray, (alpha0, s0, mem0))), jnp.asarray(y),
        jnp.asarray(vh), jnp.asarray(h), jnp.asarray(mask), with_readout=True, interpret=True)
    (ga, gs, gm), got = attention_step.fused_attention_step(
        port(params), cfg, tuple(map(torch.from_numpy, (alpha0, s0, mem0))), torch.from_numpy(y),
        torch.from_numpy(vh.copy()), torch.from_numpy(h), torch.from_numpy(mask))
    for key in ("alpha", "s", "c", "logp"):
        close(got[key], want[key])
    close(ga, wa)
    close(gs, ws)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("b,k,seed", [(8, 5, 4), (8, 1, 5), (16, 3, 6)])
def test_k8_plain_with_the_vgg_readout_matches_pallas(models, b, k, seed):
    """K8's configuration: the content-only GRU decoder with VGG's
    maxout -> linear -> maxout -> linear readout (B and L multiples of 8,
    as the Pallas kernel's supported() asks)."""
    jmodel, pmodel, params = models
    assert attention_step.k8_dense(attention_step.k8_layers(pmodel.attention_cfg)) == [
        (1, 8, 7), (0, 8, 1), (1, 8, 7), (0, 9, 1)]
    _step_parity(jmodel.attention_cfg, pmodel.attention_cfg, params["decoder"], b, k, 16, seed,
                 "K8")


@pytest.mark.parametrize("backend,seed,k", [("pallas", 2, 3), ("xla", 3, 5), ("pallas", 4, 1),
                                            ("xla", 5, 2)])
def test_beam_search_matches_jax(models, backend, seed, k):
    """Identical tokens and lengths on VGG's decoder (weights x 4, so that
    the picks move from step to step), unequal lengths and step caps."""
    jmodel, pmodel, params = models
    rng = np.random.RandomState(seed)
    b, l = 4, 16
    h = rng.randn(b, l, 16).astype(np.float32)
    lens = np.array([16, 9, 12, 3], np.int32)
    max_steps = np.array([16, 5, 12, 3], np.int32)
    dec = jax.tree.map(lambda a: 4 * a, params["decoder"])
    want = jbeam.beam_search(dec, jmodel.attention_cfg, jnp.asarray(h), jnp.asarray(lens), 0,
                             k=k, max_steps=jnp.asarray(max_steps), max_steps_cap=l,
                             backend=backend)
    got = beam.beam_search(port(dec), pmodel.attention_cfg, torch.from_numpy(h),
                           torch.from_numpy(lens), 0, k=k, max_steps=torch.from_numpy(max_steps),
                           max_steps_cap=l, device="cpu")
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,k", [(6000, 5), (6001, 8)])
def test_k2_plain_at_a_word_vocabulary_matches_pallas(v, k):
    """K2's configuration (maxout -> linear) with V = 6,000 outputs, more
    than K2 held in one block at the flagship's widths before the split
    (about 4,900 at K = 5), at small widths."""
    kw = dict(score_depth=16, state_depth=16, annotation_depth=24, output_depth=v,
              readout=(("maxout", 8, 3), ("linear", v)))
    jcfg = jatt.AttentionConfig(feature_maps=0, filt_size=5, cell="gru", mono_align=False,
                                penalty_lambda=0.0, **kw)
    params = jax.tree.map(np.asarray, jatt.attention_init(jax.random.PRNGKey(v), jcfg))
    _step_parity(jcfg, attention.AttentionConfig(**kw), params, 8, k, 16, v, "K2")


def test_recipe_matches_jax_and_initialises(models):
    """librispeech_vgg's fields are the JAX package's, and its orthogonal
    init reshapes each HWIO conv kernel to (-1, c_out) as the JAX
    package's does: equal weights from equal ones."""
    exp, jexp = experiment.librispeech_vgg(30), jexperiment.librispeech_vgg(30)
    assert (exp.name, exp.model, exp.model_kwargs) == (jexp.name, jexp.model, jexp.model_kwargs)
    assert exp.optim.__dict__ == jexp.optim.__dict__
    assert exp.orthogonalize and exp.init_std is None
    assert exp.train.eval_len_factor == jexp.train.eval_len_factor == 2.0
    from seq2seq_attention_asr_tpu.train import initializers as jinit
    from seq2seq_attention_asr_tpu_torch.train import initializers

    # the conv kernels and the readout of the seeded init (fc2 and fc3 are 2048 x 2048)
    full = models[2]
    jparams = {"encoder": {k: full["encoder"][k] for k in ("c1", "c2", "c3", "c4", "fc4")},
               "decoder": {"readout": full["decoder"]["readout"]}}
    want = jax.tree.map(np.asarray, jinit.orthogonalize_params(jparams))
    got = interop.to_numpy(initializers.orthogonalize_params(port(jparams)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    # [w^T | b] of the (9 * 128, 128) flattened kernel has orthonormal rows
    c4 = np.concatenate([got["encoder"]["c4"]["w"].reshape(-1, 128).T,
                         got["encoder"]["c4"]["b"][:, None]], axis=1)
    np.testing.assert_allclose(c4 @ c4.T, np.eye(128), atol=1e-5)
    assert vgg.encode_lengths(vgg.VGGConfig(), torch.tensor([0, 7, 8, 9, 10, 1094])).tolist() == [
        0, 0, 0, 0, 1, 543]
