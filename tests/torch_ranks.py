"""What each rank runs in the parallel tests (tests/test_torch_parallel.py,
tests/test_torch_multihost.py): functions of (rank, inputs) for
parallel.multihost.spawn, which pickles them by name, so they live in a
module that imports the port and torch only (no JAX in the ranks).
Inputs and results are numpy trees."""

import contextlib
import os

import torch

from seq2seq_attention_asr_tpu_torch import interop, tree
from seq2seq_attention_asr_tpu_torch.data import batching, synthetic
from seq2seq_attention_asr_tpu_torch.models import registry
from seq2seq_attention_asr_tpu_torch.ops import attention, readout
from seq2seq_attention_asr_tpu_torch.parallel import dp, make_mesh, mesh as mesh_lib, \
    seq_attention
from seq2seq_attention_asr_tpu_torch.train import awn, experiment, optim, trainer


@contextlib.contextmanager
def draws(noises, masks):
    """The port's draws swapped for given ones, in order, within the
    block: each weight-noise draw a list of leaves in the port's leaf
    order, each dropout mask at the global batch's shape."""
    noise_it, mask_it = iter(noises), iter(masks)

    def normal_like(generator, t):
        return tree.unflatten(t, [torch.from_numpy(a) for a in next(noise_it)])

    def dropout_keep(generator, shape, rate, device):
        keep = next(mask_it)
        assert tuple(keep.shape) == tuple(shape), (keep.shape, shape)
        return torch.from_numpy(keep).to(device)

    saved = awn.normal_like, readout.dropout_keep
    awn.normal_like, readout.dropout_keep = normal_like, dropout_keep
    try:
        yield
    finally:
        awn.normal_like, readout.dropout_keep = saved


def decode_case(mesh, case):
    """The sharded teacher-forced decode of this rank's rows: its outputs
    and the gradient of its share (1 / sp) of sum(logprobs * onehot *
    dec_mask) for every decoder weight and h."""
    cfg = attention.AttentionConfig(**case["cfg"])
    params = interop.to_torch(case["params"], "cpu")
    leaves = [t.requires_grad_(True) for t in tree.leaves(params)]
    rows = lambda a: mesh_lib.shard_batch(mesh, a)
    h = rows(case["h"]).requires_grad_(True)
    onehot, dec_mask = rows(case["onehot"]), rows(case["dec_mask"])
    out = seq_attention.sharded_decode_teacher_forced(mesh, params, cfg, h, rows(case["enc_len"]),
                                                      onehot, dec_mask)
    loss = torch.sum(out["logprobs"] * onehot * dec_mask[..., None]) / mesh.sp
    grads = torch.autograd.grad(loss, leaves + [h])
    return {"logprobs": out["logprobs"], "alpha": out["alpha"], "penalty": out["penalty"],
            "grads": list(grads[:-1]), "dh": grads[-1]}


def beam_case(mesh, case):
    cfg = attention.AttentionConfig(**case["cfg"])
    params = interop.to_torch(case["params"], "cpu")
    rows = lambda a: mesh_lib.shard_batch(mesh, a)
    lens = rows(case["lens"])
    res = seq_attention.sharded_beam_search(mesh, params, cfg, rows(case["h"]), lens, 2, k=3,
                                            max_steps=lens, max_steps_cap=case["h"].shape[1])
    return res._asdict()


def step_case(mesh, case):
    """Two sharded train steps from the case's weights with its draws:
    the last step's metrics and the train params after."""
    model = registry.build("chorowski", **case["model"])
    tcfg = trainer.TrainConfig(**case["tcfg"])
    ocfg = optim.OptimConfig(**case["ocfg"])
    tx = optim.build_optimizer(ocfg)
    step = dp.make_sharded_train_step(model, tx, tcfg, ocfg, mesh)
    state = trainer.make_init_fn(tx, tcfg)(interop.to_torch(case["params"], "cpu"),
                                           torch.Generator().manual_seed(7))
    batch = mesh_lib.put_batch(mesh, [torch.from_numpy(a) for a in case["batch"]])
    with draws(case["noises"], case["masks"]):
        for _ in range(case["steps"]):
            state, metrics = step(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": state[0]}


def fit_case(mesh, case):
    """A mesh Trainer.fit of case["epochs"] epochs in save_dir, then, with
    resume, on to case["resume_to"]: every row."""
    train, valid, v = synthetic.train_valid(**case["corpus"])
    model = registry.build("chorowski", output_depth=v, **case["model"])
    batcher = batching.BucketedBatcher(l_buckets=[32], batch_size=8)
    rows = []
    for epochs, resume in ((case["epochs"], False), (case["resume_to"], True)):
        tcfg = trainer.TrainConfig(num_epochs=epochs, **case["tcfg"])
        tr = trainer.Trainer(model, optim.OptimConfig(**case["ocfg"]), tcfg,
                             save_dir=case["save_dir"], mesh=mesh)
        tr.init(model.init(torch.Generator().manual_seed(0), device="cpu"))
        rows += list(tr.fit(train, valid, batcher, resume=resume))
    return {"rows": rows, "log": os.path.exists(os.path.join(case["save_dir"], "log.jsonl"))}


def two_by_two(rank, cases):
    """The 4-rank world's cases on a (dp=2, sp=2) mesh, then the dp=4
    train step on a (4, 1) mesh; {case: result}."""
    mesh = make_mesh(dp=2, sp=2, device="cpu")
    out = {"coords": (mesh.dp_rank, mesh.sp_rank), "decode": decode_case(mesh, cases["decode"]),
           "beam": beam_case(mesh, cases["beam"])}
    out["steps"] = {name: step_case(mesh, c) for name, c in cases["steps"].items()}
    out["fit"] = fit_case(mesh, cases["fit"])
    out["dp4"] = step_case(make_mesh(dp=4, sp=1, device="cpu"), cases["dp4"])
    return out


def run_cli_rank(rank, argv):
    """run_cli of the scriptchecker recipe under a world of ranks: the
    trainer's rows, its mesh's shape."""
    tr = experiment.run_cli(experiment.scriptchecker, "scriptchecker", argv)
    return {"rows": tr.log.rows, "shape": tr.mesh.shape, "chief": tr.is_chief}


def hang(rank, seconds):
    """Rank 1 never joins rank 0's all-reduce: a hung collective."""
    if rank == 0:
        torch.distributed.all_reduce(torch.ones(1))
    else:
        import time

        time.sleep(seconds)
    return rank


def fail(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank
