"""The committed flagship-shape checkpoint in the port.

runs/timit_shape_ckpt/full/ckpt_best_valid_PER is the chorowski_dropout
model at recipe widths, trained on the synthetic TIMIT-shaped corpus.
Loaded through the JAX package's checkpoint reader and converted with
``interop``, it must encode like the JAX model (within 1e-5) and give
identical K=5 beam tokens on held-out utterances of that corpus. Its
parameters, converted by tools/ckpt_to_npz.py into the tracked
params.npz that the card reads, must equal the checkpoint's bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.data import synthetic
from seq2seq_attention_asr_tpu.decode import beam as jbeam
from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.train import checkpoint
from seq2seq_attention_asr_tpu_torch import interop
from seq2seq_attention_asr_tpu_torch.decode import beam
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.train import checkpoint as port_checkpoint

CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "timit_shape_ckpt", "full",
                    "ckpt_best_valid_PER")
NPZ = os.path.join(os.path.dirname(CKPT), "params.npz")
EOS = 61  # the corpus's <EOS>, the last of its 62 outputs


@pytest.fixture(scope="module")
def case():
    jmodel = jregistry.build("chorowski_dropout", dropout=0.5)
    params = jax.tree.map(np.asarray, checkpoint.load(CKPT)["state"][0])
    _, valid, _ = synthetic.timit_shaped(1, 8, seed=1)
    xs = sorted((valid.x[i] for i in range(8)), key=len)[:3]  # the shortest, to keep CPU time low
    l_pad = -(-max(len(x) for x in xs) // 16) * 16
    x = np.zeros((len(xs), l_pad, 123), np.float32)
    for j, xi in enumerate(xs):
        x[j, : len(xi)] = xi
    lens = np.array([len(xi) for xi in xs], np.int32)
    return jmodel, registry.build("chorowski_dropout"), params, x, lens


def test_checkpoint_encodes_and_decodes_like_jax(case):
    jmodel, pmodel, params, x, lens = case
    tp = interop.to_torch(params, "cpu")
    want_h, _ = jmodel.encode(params, jnp.asarray(x), jnp.asarray(lens))
    got_h, _ = pmodel.encode(tp, torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)

    l_pad = x.shape[1]
    want = jbeam.beam_search(params["decoder"], jmodel.attention_cfg, want_h, jnp.asarray(lens),
                             EOS, k=5, max_steps_cap=l_pad)
    got = beam.beam_search(tp["decoder"], pmodel.attention_cfg, got_h, torch.from_numpy(lens),
                           EOS, k=5, max_steps_cap=l_pad, device="cpu")
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-5)
    # The trained model ends its hypotheses with eos well before the cap.
    ends = got.tokens.numpy()[np.arange(len(lens)), got.lengths.numpy() - 1]
    assert np.all(ends == EOS) and np.all(got.lengths.numpy() < lens)


def test_params_npz_equals_the_checkpoint(case, tmp_path):
    """Every leaf of params.npz equals the orbax checkpoint's, bit for bit,
    as float32; load_params_npz gives the tree interop.to_torch gives
    (the readout's dropout entry an empty dict); tools/ckpt_to_npz.py
    writes the same file again."""
    import sys

    _, _, params, _, _ = case
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    with np.load(NPZ) as z:
        got = {k: z[k] for k in z.files}
    names = {"/".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path): leaf
             for path, leaf in want.items()}
    assert sorted(got) == sorted(names)
    for k, leaf in names.items():
        assert got[k].dtype == np.float32 and leaf.dtype == np.float32
        np.testing.assert_array_equal(got[k], leaf, err_msg=k)
    loaded = port_checkpoint.load_params_npz(NPZ, "cpu")
    ref = interop.to_torch(params, "cpu")
    assert jax.tree.structure(interop.to_numpy(loaded)) == jax.tree.structure(
        interop.to_numpy(ref))
    assert loaded["decoder"]["readout"][0] == {}
    for a, b in zip(jax.tree.leaves(interop.to_numpy(loaded)),
                    jax.tree.leaves(interop.to_numpy(ref))):
        np.testing.assert_array_equal(a, b)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        import ckpt_to_npz
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "params.npz")
    assert ckpt_to_npz.main(["--ckpt", CKPT, "--out", out]) == 0
    with open(out, "rb") as f, open(NPZ, "rb") as g:
        assert f.read() == g.read()
