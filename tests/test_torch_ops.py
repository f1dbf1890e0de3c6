"""Parity of the PyTorch port's plain modules with the JAX package on the CPU.

Inputs are made with numpy from a seed and go through the JAX function
and its port; weights are made by the JAX package and converted with
``interop``. Tolerance: float32 forward rtol 2e-5 (atol 2e-6), the JAX
package's own parity tolerance (tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import attention as jatt
from seq2seq_attention_asr_tpu.ops import cells as jcells
from seq2seq_attention_asr_tpu.ops import masking as jmask
from seq2seq_attention_asr_tpu.ops import readout as jro
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.ops import attention, cells, masking, readout

RTOL, ATOL = 2e-5, 2e-6


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


SMALL = dict(input_frame_size=10, hidden_frame_size=16, output_frame_size=16, score_depth=16,
             state_depth=16, mlp_depth=8, output_depth=7)


def test_interop_round_trip_is_lossless():
    params = jregistry.build("chorowski", dropout=0.5, **SMALL).init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    back = interop.to_numpy(interop.to_torch(host, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_port_init_has_the_jax_tree(dropout):
    """The port's own init makes the JAX package's tree: same keys, list
    order and shapes, so weights move either way through interop."""
    want = jregistry.build("chorowski", dropout=dropout, **SMALL).init(jax.random.PRNGKey(1))
    got = registry.build("chorowski", dropout=dropout, **SMALL).init(
        torch.Generator().manual_seed(1), device="cpu")
    got = interop.to_numpy(got)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want))
    assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(want)]


def test_length_mask_and_masked_softmax():
    rng = np.random.RandomState(0)
    lens = np.array([5, 1, 7, 0], np.int32)
    e = rng.randn(4, 7).astype(np.float32) * 3
    want_m = jmask.length_mask(jnp.asarray(lens), 7)
    got_m = masking.length_mask(torch.from_numpy(lens), 7)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    want = jmask.masked_softmax(jnp.asarray(e), want_m)
    got = masking.masked_softmax(torch.from_numpy(e), got_m)
    close(got, want)
    assert np.all(got.numpy()[got_m.numpy() == 0] == 0.0)


def test_gru_cell_functions():
    rng = np.random.RandomState(1)
    p = jcells.gru_init(jax.random.PRNGKey(2), 6, 9)
    x = rng.randn(3, 4, 6).astype(np.float32)
    h = rng.randn(3, 4, 9).astype(np.float32) * 0.5
    tp = port(p)
    close(cells.gru_step(tp, torch.from_numpy(x), torch.from_numpy(h)),
          jcells.gru_step(p, jnp.asarray(x), jnp.asarray(h)))
    xp_want = jcells.gru_input_proj(p, jnp.asarray(x))
    xp_got = cells.gru_input_proj(tp, torch.from_numpy(x))
    close(xp_got, xp_want)
    close(cells.gru_step_preproj(tp, xp_got, torch.from_numpy(h)),
          jcells.gru_step_preproj(p, xp_want, jnp.asarray(h)))


def test_readout_stack():
    rng = np.random.RandomState(3)
    specs = (("dropout", 0.5), ("maxout", 5, 3), ("relu",), ("linear", 7))
    p = jro.stack_init(jax.random.PRNGKey(4), 12, specs)
    x = rng.randn(2, 3, 12).astype(np.float32)
    tp = port(p)
    x5 = rng.randn(4, 5).astype(np.float32)
    close(readout.linear_apply(tp[3], torch.from_numpy(x5)), jro.linear_apply(p[3], jnp.asarray(x5)))
    close(readout.maxout_apply(tp[1], torch.from_numpy(x), 3),
          jro.maxout_apply(p[1], jnp.asarray(x), 3))
    got = readout.stack_apply(tp, specs, torch.from_numpy(x))
    assert got.dtype == torch.float32
    close(got, jro.stack_apply(p, specs, jnp.asarray(x), train=False))


@pytest.fixture(scope="module")
def att_case():
    jcfg = jatt.AttentionConfig(
        score_depth=16, filt_size=5, feature_maps=0, state_depth=12, annotation_depth=20,
        output_depth=6, cell="gru", mono_align=False,
        readout=(("dropout", 0.5), ("maxout", 8, 3), ("linear", 6)),
    )
    cfg = attention.AttentionConfig(score_depth=16, state_depth=12, annotation_depth=20,
                                    output_depth=6, readout=jcfg.readout)
    params = jatt.attention_init(jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(6)
    b, l = 3, 10
    lens = np.array([10, 4, 7], np.int32)
    data = dict(
        h=rng.randn(b, l, 20).astype(np.float32),
        s=(rng.randn(b, 12) * 0.3).astype(np.float32),
        y=np.eye(6, dtype=np.float32)[rng.randint(0, 6, b)],
        mask=(np.arange(l)[None] < lens[:, None]).astype(np.float32),
    )
    return jcfg, cfg, params, data


def test_attention_step_and_readout(att_case):
    jcfg, cfg, params, d = att_case
    tp = port(params)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    vh_want = jatt.precompute_vh(params, jnp.asarray(d["h"]))
    vh_got = attention.precompute_vh(tp, t["h"])
    close(vh_got, vh_want)
    b, l = d["mask"].shape
    zeros = np.zeros((b, 12), np.float32)
    jstate = (jnp.zeros((b, l)), jnp.asarray(d["s"]), jnp.asarray(zeros))
    (wa, ws, wm), want = jatt.attention_step(
        params, jcfg, jstate, jnp.asarray(d["y"]), vh_want, jnp.asarray(d["h"]),
        jnp.asarray(d["mask"]), ramp=None)
    state = (torch.zeros(b, l), t["s"], torch.from_numpy(zeros))
    (ga, gs, gm), got = attention.attention_step(tp, cfg, state, t["y"], vh_got, t["h"], t["mask"])
    for key in ("alpha", "s", "c"):
        close(got[key], want[key])
    close(gs, ws)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    close(attention.apply_readout(tp, cfg, got["s"], got["c"]),
          jatt.apply_readout(params, jcfg, want["s"], want["c"]))
    for g, w in zip(attention.init_state(cfg, 2, 5), jatt.init_state(jcfg, 2, 5)):
        assert tuple(g.shape) == w.shape and not g.any()
