"""The port's one-direction GRU scan (kernel K16's and K17's plain
versions, ``GRUScan``), its direction-stacked BiGRU scan (K18's and
K19's, ``BiGRUScan``) and ``rnn.gru_layer`` against the JAX package on
the CPU, with the Pallas kernels in interpret mode, as
tests/test_pallas.py runs them; the BiGRU encoder built from either
scan against the port's flip-free ``bigru_layer``; and the kernels'
trace names.

Tolerances: the JAX package's own (tests/test_pallas.py:45-67):
float32 forward rtol 2e-5 (atol 2e-6), gradients rtol 5e-4 (atol
5e-5), sums over B*L rows taken in another order.
"""

import itertools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from seq2seq_attention_asr_tpu.ops import cells as jcells
from seq2seq_attention_asr_tpu.ops import rnn as jrnn
from seq2seq_attention_asr_tpu.ops.pallas import gru_scan as jgs
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.ops import cells, rnn
from seq2seq_attention_asr_tpu_torch.ops.cuda import gru_scan
from seq2seq_attention_asr_tpu_torch.ops.masking import length_mask

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
CSRC = pathlib.Path(__file__).resolve().parents[1] / "seq2seq_attention_asr_tpu_torch" / "csrc"


def port(tree):
    return interop.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=err_msg)


@pytest.fixture(scope="module")
def scans():
    """Seeded numpy inputs of both scans at H = 64, direction 1 of the
    stacked ones with weights of its own: xproj, a nonzero h0 (scale 0.5,
    and a large one, scale 3, for the backward's initial-state term),
    the recurrent weights, and a cotangent of the outputs."""
    rng = np.random.RandomState(0)
    b, l, h = 4, 11, 64
    f = lambda *shape, scale=1.0: (rng.randn(*shape) * scale).astype(np.float32)
    return {
        "xproj2": f(2, b, l, 3 * h, scale=0.5), "h02": f(2, b, h, scale=0.5),
        "big_h02": f(2, b, h, scale=3.0), "wzr2": f(2, h, 2 * h, scale=0.15),
        "wh2": f(2, h, h, scale=0.15), "cot2": f(2, b, l, h),
    }


def _one(scans, l, d=0):
    """Direction d's inputs of the fixture, cut to l steps."""
    return (scans["xproj2"][d, :, :l], scans["h02"][d], scans["wzr2"][d], scans["wh2"][d],
            scans["cot2"][d, :, :l])


def test_gru_scan_plain_matches_pallas(scans):
    xproj, h0, wzr, wh, _ = _one(scans, 7)
    want = jgs.gru_scan(*map(jnp.asarray, (xproj, h0, wzr, wh)), True)
    got = gru_scan.gru_scan(*map(torch.from_numpy, (xproj, h0, wzr, wh)))
    assert got.shape == want.shape
    close(got, want)


def test_gru_scan_gradient_matches_pallas(scans):
    """GRUScan's gradient for xproj, h0, Wzr and Wh against jax.grad of
    the Pallas kernel (its _vjp_bwd)."""
    xproj, h0, wzr, wh, cot = _one(scans, 7)
    want = jax.grad(lambda *a: jnp.sum(jgs.gru_scan(*a, True) * cot), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (xproj, h0, wzr, wh)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xproj, h0, wzr, wh)]
    got = torch.autograd.grad((gru_scan.GRUScan.apply(*args) * torch.from_numpy(cot)).sum(), args)
    for name, g, w in zip(("dxproj", "dh0", "dwzr", "dwh"), got, want):
        close(g, w, GRAD_RTOL, GRAD_ATOL, name)


def test_gru_scan_bwd_plain_matches_pallas_run_bwd(scans):
    """K17's plain version on the Pallas forward's shifted states from a
    large h0, against the Pallas backward (_run_bwd) directly. The
    initial state's term of dWzr, h0^T [da_z | da_r] at t = 0, is well
    above the tolerance, so a reduction that read a zero row there would
    fail."""
    xproj, _, wzr, wh, cot = _one(scans, 7)
    h0 = scans["big_h02"][0]
    ys = np.asarray(jgs._run_fwd(*map(jnp.asarray, (xproj, h0, wzr, wh)), interpret=True))
    h_prevs = np.concatenate([h0[:, None], ys[:, :-1]], axis=1)
    want = jgs._run_bwd(*map(jnp.asarray, (xproj, h_prevs, cot, wzr, wh)), interpret=True)
    got = gru_scan.gru_scan_bwd(*map(torch.from_numpy, (xproj, h_prevs, cot, wzr, wh)))
    for name, g, w in zip(("dxproj", "dh0", "dwzr", "dwh"), got, want):
        close(g, w, GRAD_RTOL, GRAD_ATOL, name)
    dxproj = np.asarray(want[0])
    h0_term = h0.T @ dxproj[:, 0, : 2 * h0.shape[1]]
    assert np.abs(h0_term).max() > 100 * (GRAD_ATOL + GRAD_RTOL * np.abs(np.asarray(want[2])).max())


@pytest.mark.parametrize("l", [6, 11])
def test_bigru_scan_plain_matches_pallas(scans, l):
    """L = 6 and 11, neither a multiple of the Pallas kernel's TBLK = 8."""
    args = (scans["xproj2"][:, :, :l], scans["h02"], scans["wzr2"], scans["wh2"])
    want = jgs.bigru_scan(*map(jnp.asarray, args), True)
    got = gru_scan.bigru_scan(*map(torch.from_numpy, args))
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("l", [6, 11])
def test_bigru_scan_gradient_matches_pallas(scans, l):
    args = (scans["xproj2"][:, :, :l], scans["h02"], scans["wzr2"], scans["wh2"])
    cot = scans["cot2"][:, :, :l]
    want = jax.grad(lambda *a: jnp.sum(jgs.bigru_scan(*a, True) * cot), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad((gru_scan.BiGRUScan.apply(*targs) * torch.from_numpy(cot)).sum(),
                              targs)
    for name, g, w in zip(("dxproj2", "dh02", "dwzr2", "dwh2"), got, want):
        close(g, w, GRAD_RTOL, GRAD_ATOL, name)


@pytest.mark.parametrize("stacked", [False, True])
def test_scan_autograd_functions_pass_gradcheck(stacked):
    rng = np.random.RandomState(3)
    lead = (2,) if stacked else ()
    b, l, h = 2, 4, 3
    shapes = ((b, l, 3 * h), (b, h), (h, 2 * h), (h, h))
    scales = (1.0, 0.5, 0.4, 0.4)
    args = [torch.from_numpy(rng.randn(*lead, *s) * c).requires_grad_(True)
            for s, c in zip(shapes, scales)]
    fn = gru_scan.BiGRUScan.apply if stacked else gru_scan.GRUScan.apply
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("reverse,ragged,with_h0", list(itertools.product([False, True], repeat=3)))
def test_gru_layer_matches_jax(reverse, ragged, with_h0):
    """The port's gru_layer against JAX gru_layer(backend="pallas"),
    forward and the gradient of sum(y * w) for the weights, x and h0, at
    every position: past a row's length the scan runs on into the
    padding, and both return those positions unmasked."""
    params = jcells.gru_init(jax.random.PRNGKey(4), 10, 32)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 10).astype(np.float32)
    w = rng.randn(3, 7, 32).astype(np.float32)
    h0 = (rng.randn(3, 32) * 0.5).astype(np.float32)
    lens = np.array([7, 4, 2], np.int32) if ragged else None

    def jfn(p, xx, hh):
        return jrnn.gru_layer(p, xx, None if lens is None else jnp.asarray(lens), reverse=reverse,
                              h0=hh if with_h0 else None, backend="pallas")

    want = jfn(params, jnp.asarray(x), jnp.asarray(h0))
    wgp, wgx, wgh = jax.grad(lambda p, xx, hh: jnp.sum(jfn(p, xx, hh) * w), argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(h0))
    tp = {k: v.requires_grad_(True) for k, v in port(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(h0).requires_grad_(True)
    got = rnn.gru_layer(tp, tx, None if lens is None else torch.from_numpy(lens), reverse=reverse,
                        h0=th if with_h0 else None)
    close(got, want)
    wrt = [tp["w_zr"], tp["w_h"], tx] + ([th] if with_h0 else [])
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), wrt)
    close(grads[0], wgp["w_zr"], GRAD_RTOL, GRAD_ATOL, "w_zr")
    close(grads[1], wgp["w_h"], GRAD_RTOL, GRAD_ATOL, "w_h")
    close(grads[2], wgx, GRAD_RTOL, GRAD_ATOL, "x")
    if with_h0:
        close(grads[3], wgh, GRAD_RTOL, GRAD_ATOL, "h0")


# Twins of tests/test_rnn.py:25-69 for the port's gru_layer.


def test_gru_layer_matches_python_loop():
    gen = torch.Generator().manual_seed(1)
    p = cells.gru_init(gen, 3, 4)
    x = torch.randn(2, 5, 3, generator=gen)
    ys = rnn.gru_layer(p, x)
    h = torch.zeros(2, 4)
    for t in range(5):
        h = cells.gru_step(p, x[:, t], h)
        close(ys[:, t], h.numpy(), 1e-5, 1e-6)


def test_reverse_gru_layer_semantics():
    """output[t] of a reverse layer = state after consuming x[t..len-1]."""
    gen = torch.Generator().manual_seed(3)
    p = cells.gru_init(gen, 3, 4)
    x = torch.randn(1, 6, 3, generator=gen)
    ys = rnn.gru_layer(p, x, torch.tensor([4]), reverse=True)
    h = torch.zeros(1, 4)
    for t in range(3, -1, -1):
        h = cells.gru_step(p, x[:, t], h)
        close(ys[:, t], h.numpy(), 1e-5, 1e-6)


def test_forward_layer_padding_independence():
    """Valid outputs must not depend on values in the padded region."""
    gen = torch.Generator().manual_seed(5)
    p = cells.gru_init(gen, 3, 4)
    x1 = torch.randn(1, 6, 3, generator=gen)
    x2 = x1.clone()
    x2[:, 4:] = 99.0
    lengths = torch.tensor([4])
    for reverse in (False, True):
        y1 = rnn.gru_layer(p, x1, lengths, reverse=reverse)
        y2 = rnn.gru_layer(p, x2, lengths, reverse=reverse)
        close(y1[:, :4], y2[:, :4].numpy(), 1e-5, 0)


@pytest.mark.parametrize("path", ["per_direction", "stacked"])
def test_encoder_paths_match_bigru_layer(path):
    """Three BiGRU layers (10 -> 16 -> 16 -> 16 per direction, ragged
    lengths) built as chip_smoke.py builds them, one gru_layer per
    direction (path (a)) or through bigru_scan (path (b)), against the
    port's flip-free bigru_layer: the same output at valid positions,
    exactly 0 at masked ones, and the same gradient of sum(y * w) for
    every weight and the input."""
    gen = torch.Generator().manual_seed(6)
    enc = {"bigru1": rnn.bigru_init(gen, 10, 16), "bigru2": rnn.bigru_init(gen, 32, 16),
           "bigru3": rnn.bigru_init(gen, 32, 16)}
    x = torch.randn(4, 9, 10, generator=gen)
    w = torch.randn(4, 9, 32, generator=gen)
    lengths = torch.tensor([9, 5, 7, 2])
    got, grads = chip_smoke.encoder_call(path, enc, x, lengths, w)()
    want, want_grads = chip_smoke.encoder_call("bigru_layer", enc, x, lengths, w)()
    mask = length_mask(lengths, 9)[:, :, None].expand(-1, -1, 32).bool()
    close(got[mask], want[mask])
    assert not got[~mask].any()
    assert len(grads) == len(want_grads) == 13  # 12 weights and x
    for i, (g, ref) in enumerate(zip(grads, want_grads)):
        close(g, ref, GRAD_RTOL, GRAD_ATOL, str(i))


def test_kernel_trace_names_hold_no_other():
    """The profiler's records and chip_smoke.py's tables find a kernel by
    a substring of its name, so no __global__ name of csrc/ may hold
    another."""
    names = set()
    for path in sorted(CSRC.glob("*.cu*")):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                path.read_text()))
    assert {"bigru_scan2_kernel", "atb_kernel", "gru1_walk_fwd_kernel", "gru1_walk_bwd_kernel",
            "gru2_stacked_fwd_kernel", "gru2_stacked_bwd_kernel", "gru_gates_kernel",
            "lstm_gates_kernel", "bilstm_scan_bwd_kernel", "bigru_scan2_bwd_kernel"} <= names
    clashes = [(a, b) for a in names for b in names if a != b and a in b]
    assert not clashes, clashes
