"""The port's dp x sp layer (seq2seq_attention_asr_tpu_torch/parallel) on
the CPU: four ranks over gloo (parallel.multihost.spawn, one thread a
rank, a time limit of their own) on a (dp=2, sp=2) mesh, against the JAX
package's parallel/ functions on a (2, 2) mesh of the virtual CPU devices
of tests/conftest.py, at the shapes of tests/test_parallel.py:

  - the sequence-sharded teacher-forced decode, forward and gradients;
  - the sharded beam with dp = 2, a location convolution and unequal
    lengths on each dp shard (the JAX package's MULTICHIP_r03 deadlock:
    a rank that left its loop early would hang its neighbours' halo
    exchange; the time limit turns a hang into a failure);
  - two dp x sp train steps under AWN and under weight noise, each with
    readout dropout 0.4 (so that both draws, the noise's and then the
    mask's, are checked in their order), JAX's draws swapped into the
    ranks; and the weight-noise steps on a (4, 1) mesh, the decoder's
    kernels' path;
  - the mesh Trainer.fit with a ragged valid batch and a resume, against
    the port's own single-rank fit.

One world of four ranks runs every case (tests/torch_ranks.py::two_by_two)
while this process compiles and runs the JAX side, each JAX function in
a thread of its own; each test reads its case. The weights are the
port's init, fed to both packages.

Tolerances: the JAX package's (tests/test_pallas.py:45-67, as
tests/test_torch_gru_scan.py holds them): forward rtol 2e-5 (atol 2e-6),
gradients and the parameters after two steps rtol 5e-4 (atol 5e-5); the
metrics of a step rtol 2e-5; beam tokens and lengths identical. The fit
is held as tests/test_parallel.py holds the JAX mesh fit: losses rtol
2e-4, accuracy and PER within 1e-6.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2seq_attention_asr_tpu.models import registry as jregistry
from seq2seq_attention_asr_tpu.ops import attention as jattention
from seq2seq_attention_asr_tpu.parallel import dp as jdp
from seq2seq_attention_asr_tpu.parallel import make_mesh as jmake_mesh
from seq2seq_attention_asr_tpu.parallel import seq_attention as jseq
from seq2seq_attention_asr_tpu.train import optim as joptim
from seq2seq_attention_asr_tpu.train import trainer as jtrainer
from seq2seq_attention_asr_tpu_torch import interop, tree
from seq2seq_attention_asr_tpu_torch.data import batching, synthetic
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.ops import attention
from seq2seq_attention_asr_tpu_torch.parallel import multihost
from seq2seq_attention_asr_tpu_torch.train import optim, trainer
from test_torch_dropout import JaxDraws, as_port_tree, close_by_path

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
RANKS_TIMEOUT = 120.0  # seconds for the whole world; a hang fails the tests

DECODE_CFG = dict(score_depth=12, filt_size=5, feature_maps=3, state_depth=8,
                  annotation_depth=10, output_depth=6, mono_align=True, penalty_lambda=0.3,
                  readout=(("maxout", 8, 2), ("linear", 6)))
BEAM_CFG = dict(score_depth=16, filt_size=5, feature_maps=4, state_depth=16,
                annotation_depth=24, output_depth=6, cell="gru", mono_align=False,
                penalty_lambda=0.0, readout=(("linear", 6),))
STEP_MODEL = dict(input_frame_size=6, hidden_frame_size=8, output_frame_size=8, score_depth=12,
                  state_depth=8, mlp_depth=6, output_depth=7, feature_maps=3, filt_size=5,
                  penalty_lambda=0.2)
STEP_TCFG = dict(normalize_nll=True, awn_lambda=0.5, awn_sigma_init=0.05,
                 weight_noise_sigma=0.02)
STEP_OCFG = dict(maxnorm=5.0, colnorm=True, colnorm_maxval=3.0)
VARIANTS = {"awn_dropout": "awn", "weight_dropout": "weight"}
DROPOUT = 0.4
FIT_CORPUS = dict(n_train=16, n_valid=7, n_phones=5, feat_dim=8, min_len=2, max_len=4,
                  frames_per_phone=(2, 4), noise=0.2, seed=0)
FIT_MODEL = dict(input_frame_size=8, hidden_frame_size=8, output_frame_size=8, score_depth=12,
                 state_depth=8, mlp_depth=6, feature_maps=3, filt_size=5, dropout=0.4)
FIT_TCFG = dict(batch_size=8, normalize_nll=True, beam_k=2, seed=5)
FIT_OCFG = dict(colnorm=True, colnorm_maxval=2.0)


def _decode_inputs():
    cfg = attention.AttentionConfig(**DECODE_CFG)
    params = interop.to_numpy(attention.attention_init(torch.Generator().manual_seed(0), cfg))
    rng = np.random.RandomState(1)
    b, l, t = 4, 16, 5
    labels = rng.randint(0, cfg.output_depth, (b, t))
    return dict(cfg=DECODE_CFG, params=params,
                h=rng.randn(b, l, cfg.annotation_depth).astype(np.float32),
                enc_len=np.array([16, 12, 9, 16]),
                onehot=np.eye(cfg.output_depth, dtype=np.float32)[labels],
                dec_mask=(np.arange(t)[None] < np.array([5, 4, 2, 5])[:, None]).astype(
                    np.float32))


def _beam_inputs():
    cfg = attention.AttentionConfig(**BEAM_CFG)
    params = interop.to_numpy(attention.attention_init(torch.Generator().manual_seed(0), cfg))
    b, l = 8, 16  # dp = 2: 4 rows a shard; l divides sp = 2
    lens = np.array([16, 9, 12, 5, 8, 16, 11, 13])
    h = np.random.RandomState(1).randn(b, l, 24).astype(np.float32) * 0.5
    h = h * (np.arange(l)[None, :, None] < lens[:, None, None])
    return dict(cfg=BEAM_CFG, params=params, h=h, lens=lens)


def _step_batch():
    rng = np.random.RandomState(3)
    b, t = 4, 5
    return [rng.randn(b, 16, 6).astype(np.float32), np.array([16, 11, 7, 16]),
            rng.randint(0, 7, (b, t)), np.ones((b, t), np.float32)]


def _step_inputs(noise, steps=2):
    """A variant's case for the ranks: the weights and JAX's draws of each
    step, the noise's and the dropout mask's (torch_ranks.draws puts them
    in place of the port's)."""
    model = dict(STEP_MODEL, dropout=DROPOUT)
    params = registry.build("chorowski", **model).init(torch.Generator().manual_seed(0),
                                                       device="cpu")
    draws = JaxDraws(7)
    noises, masks = [], []
    st, a = STEP_MODEL["state_depth"], 2 * STEP_MODEL["output_frame_size"]
    for _ in range(steps):
        draws.next_step()
        noises.append([x.numpy() for x in tree.leaves(draws.normal_like(None, params))])
        masks.append(draws.dropout_keep(None, (4, 5, st + a), DROPOUT, "cpu").numpy())
    return dict(model=model, params=interop.to_numpy(params),
                tcfg=dict(STEP_TCFG, noise=noise), ocfg=STEP_OCFG, noises=noises, masks=masks,
                batch=_step_batch(), steps=steps)


def _jmesh():
    return jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4])


def _jax_decode(c):
    """JAX's sharded decode on the (2, 2) mesh: its outputs, and its
    gradient of sum(logprobs * onehot * dec_mask) for the weights and h."""
    cfg = jattention.AttentionConfig(**DECODE_CFG)
    mesh = _jmesh()

    def loss(p, hh):
        out = jseq.sharded_decode_teacher_forced(mesh, p, cfg, hh, c["enc_len"], c["onehot"],
                                                 c["dec_mask"])
        return jnp.sum(out["logprobs"] * c["onehot"] * c["dec_mask"][..., None]), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(c["params"],
                                                                             c["h"])
    return jax.tree.map(np.asarray, (out, grads))


def _jax_beam(c):
    from seq2seq_attention_asr_tpu.decode import beam as jbeam

    cfg = jattention.AttentionConfig(**BEAM_CFG)
    kw = dict(eos_id=2, k=3, max_steps=c["lens"], max_steps_cap=16)
    return (jseq.sharded_beam_search(_jmesh(), c["params"], cfg, c["h"], c["lens"], **kw),
            jbeam.beam_search(c["params"], cfg, c["h"], c["lens"], **kw))


def _jax_steps(c):
    """JAX's make_sharded_train_step on the (2, 2) mesh from the case's
    weights: the last step's metrics and the train params."""
    model = jregistry.build("chorowski", **c["model"])
    tcfg = jtrainer.TrainConfig(**c["tcfg"])
    ocfg = joptim.OptimConfig(**c["ocfg"])
    tx = joptim.build_optimizer(ocfg)
    step = jdp.make_sharded_train_step(model, tx, tcfg, ocfg, _jmesh())
    state = jtrainer.make_init_fn(tx, tcfg)(jax.tree.map(jnp.asarray, c["params"]),
                                            jax.random.PRNGKey(7))
    batch = tuple(jnp.asarray(a) for a in c["batch"])
    for _ in range(c["steps"]):
        state, metrics = step(state, batch)
    return {k: float(v) for k, v in metrics.items()}, state[0]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's inputs; the four ranks started on them, and each JAX
    reference, as futures."""
    import torch_ranks

    steps = {name: _step_inputs(noise) for name, noise in VARIANTS.items()}
    cases = {"decode": _decode_inputs(), "beam": _beam_inputs(), "steps": steps,
             "dp4": steps["weight_dropout"],
             "fit": dict(corpus=FIT_CORPUS, model=FIT_MODEL, tcfg=FIT_TCFG, ocfg=FIT_OCFG,
                         epochs=2, resume_to=3,
                         save_dir=str(tmp_path_factory.mktemp("mesh_fit")))}
    pool = ThreadPoolExecutor(2 + len(VARIANTS) + 1)
    ranks = pool.submit(multihost.spawn, torch_ranks.two_by_two, 4, cases,
                        timeout=RANKS_TIMEOUT)
    refs = {"decode": pool.submit(_jax_decode, cases["decode"]),
            "beam": pool.submit(_jax_beam, cases["beam"])}
    refs.update({name: pool.submit(_jax_steps, c) for name, c in steps.items()})
    yield {"cases": cases, "ranks": ranks.result, "jax": {k: f.result for k, f in refs.items()}}
    pool.shutdown(wait=True)


def _by_coords(results):
    return {r["coords"]: r for r in results}


def test_ranks_take_the_jax_meshs_coordinates(world):
    """Rank r sits at (r // sp, r % sp), as the JAX mesh lays out its
    devices."""
    assert [tuple(r["coords"]) for r in world["ranks"]()] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_decode_matches_jax_forward(world):
    want, _ = world["jax"]["decode"]()
    got = _by_coords(world["ranks"]())
    for key in ("logprobs", "penalty"):
        for i in range(2):
            for j in range(2):  # every sp rank holds its rows' whole result
                np.testing.assert_allclose(got[(i, j)]["decode"][key], want[key][2 * i:2 * i + 2],
                                           rtol=RTOL, atol=ATOL, err_msg=key)
    alpha = np.concatenate([np.concatenate([got[(i, j)]["decode"]["alpha"] for j in range(2)],
                                           axis=-1) for i in range(2)])
    np.testing.assert_allclose(alpha, want["alpha"], rtol=RTOL, atol=ATOL)


def test_sharded_decode_matches_jax_gradients(world):
    """The sum over the world of each rank's gradient of its share is
    JAX's gradient of the global loss, for every decoder weight and h."""
    c = world["cases"]["decode"]
    _, (gw, gh) = world["jax"]["decode"]()
    results = world["ranks"]()
    summed = [sum(r["decode"]["grads"][k] for r in results)
              for k in range(len(results[0]["decode"]["grads"]))]
    got = tree.unflatten(interop.to_torch(c["params"], "cpu"), [torch.from_numpy(g)
                                                                for g in summed])
    close_by_path(got, as_port_tree(gw), GRAD_RTOL, GRAD_ATOL)
    by = _by_coords(results)
    dh = np.concatenate([by[(i, 0)]["decode"]["dh"] + by[(i, 1)]["decode"]["dh"]
                         for i in range(2)])
    np.testing.assert_allclose(dh, gh, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_sharded_beam_dp_with_loc_conv_unequal_lengths(world):
    """The world ends (no rank hangs in a neighbour's halo exchange) and
    the beam matches the JAX package's sharded and unsharded beams: the
    same tokens and lengths, the scores within the forward tolerance."""
    want, plain = world["jax"]["beam"]()
    by = _by_coords(world["ranks"]())
    for j in range(2):  # both sp ranks of a dp rank hold its rows' result
        got = {k: np.concatenate([by[(i, j)]["beam"][k] for i in range(2)])
               for k in ("tokens", "lengths", "scores")}
        for ref in (want, plain):
            np.testing.assert_array_equal(got["tokens"], np.asarray(ref.tokens))
            np.testing.assert_array_equal(got["lengths"], np.asarray(ref.lengths))
            np.testing.assert_allclose(got["scores"], np.asarray(ref.scores), rtol=RTOL,
                                       atol=ATOL)


def _hold_step(got, want_metrics, want_params):
    assert set(got["metrics"]) == set(want_metrics)
    for k, w in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL, err_msg=k)
    params = interop.to_torch(got["params"], "cpu")
    close_by_path(params, as_port_tree(want_params), GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dp_sp_train_step_matches_jax(world, variant):
    """Two (2, 2) train steps under AWN or weight noise, with dropout 0.4,
    the monotonic penalty and the column-norm projection, against the JAX
    package's make_sharded_train_step with the same draws: the last step's
    metrics and every parameter, on every rank alike."""
    want_metrics, want_params = world["jax"][variant]()
    results = world["ranks"]()
    for r in results:
        _hold_step(r["steps"][variant], want_metrics, want_params)
    first = results[0]["steps"][variant]["params"]
    for r in results[1:]:  # one update on every rank, bit for bit
        for a, b in zip(tree.leaves(first), tree.leaves(r["steps"][variant]["params"])):
            np.testing.assert_array_equal(a, b)


def test_dp_train_step_on_the_kernels_path_matches_jax(world):
    """The weight-noise steps on a (4, 1) mesh: the decoder's kernels'
    path (no sp group; their plain versions here), each rank's rows'
    share of the mask drawn at the global shape; the JAX package's steps
    are the same under every mesh shape (tests/test_parallel.py)."""
    want_metrics, want_params = world["jax"]["weight_dropout"]()
    for r in world["ranks"]():
        _hold_step(r["dp4"], want_metrics, want_params)


def test_mesh_trainer_fit_matches_the_single_rank_fit(world):
    """The (2, 2) mesh Trainer.fit, 2 epochs then a resume to the third,
    against the port's single-rank fit of 3 epochs from the same weights
    on the same batches: the 7-utterance valid set pads to 8 with a dead
    row, which moves no loss, NLL, accuracy or PER. Rank 0 alone writes
    the log."""
    c = world["cases"]["fit"]
    train, valid, v = synthetic.train_valid(**FIT_CORPUS)
    model = registry.build("chorowski", output_depth=v, **FIT_MODEL)
    tr = trainer.Trainer(model, optim.OptimConfig(**FIT_OCFG),
                         trainer.TrainConfig(num_epochs=3, **FIT_TCFG), device="cpu")
    tr.init(model.init(torch.Generator().manual_seed(0), device="cpu"))
    single = list(tr.fit(train, valid, batching.BucketedBatcher(l_buckets=[32], batch_size=8)))
    results = world["ranks"]()
    assert [r["fit"]["log"] for r in results] == [True] * 4  # the shared save_dir's log
    for r in results:
        rows = r["fit"]["rows"]
        assert [row["epoch"] for row in rows] == [1, 2, 3]
        for s, m in zip(single, rows):
            assert m["train_loss"] == pytest.approx(s["train_loss"], rel=2e-4)
            assert m["valid_nll"] == pytest.approx(s["valid_nll"], rel=2e-4)
            assert m["valid_accuracy"] == pytest.approx(s["valid_accuracy"], abs=1e-6)
            assert m["valid_per"] == pytest.approx(s["valid_per"], abs=1e-6)
