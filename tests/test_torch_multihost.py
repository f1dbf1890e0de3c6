"""The port's world of ranks (parallel/multihost.py, parallel/mesh.py) on
the CPU: the per-rank data helpers against the JAX package's
(tests/test_multihost.py), the mesh's shards against the shards of the
JAX package's shardings on the virtual CPU devices of tests/conftest.py,
the spawner's time limit and error path, and run_cli --dp 2 under two
gloo ranks against the single-rank run_cli (and --dp 1, a world of one
rank with no process group, bit for bit)."""

import multiprocessing

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from seq2seq_attention_asr_tpu.data.timit import Dataset as JDataset
from seq2seq_attention_asr_tpu.parallel import make_mesh as jmake_mesh
from seq2seq_attention_asr_tpu.parallel import mesh as jmesh
from seq2seq_attention_asr_tpu.parallel import multihost as jmultihost
from seq2seq_attention_asr_tpu_torch.data import synthetic, timit
from seq2seq_attention_asr_tpu_torch.parallel import make_mesh, mesh as mesh_lib, multihost
from seq2seq_attention_asr_tpu_torch.train import experiment

import torch_ranks


def _fields(n):
    rng = np.random.RandomState(0)
    return dict(
        uids=[f"u{i}" for i in range(n)],
        x=[rng.randn(5 + i, 4).astype(np.float32) for i in range(n)],
        y=[rng.randint(0, 7, (3,)).astype(np.int32) for _ in range(n)],
        y39=[rng.randint(0, 5, (3,)).astype(np.int32) for _ in range(n)],
        start=[np.zeros(1, np.int64)] * n,
        finish=[np.ones(1, np.int64)] * n,
    )


@pytest.mark.parametrize("n_hosts", [1, 3])
def test_host_shard_matches_jax(n_hosts):
    """Utterance-level round robin, the same slices as the JAX package's,
    and the dataset itself on one host."""
    ds, jds = timit.Dataset(**_fields(10)), JDataset(**_fields(10))
    for p in range(n_hosts):
        got = multihost.host_shard(ds, process_id=p, process_count=n_hosts)
        want = jmultihost.host_shard(jds, process_id=p, process_count=n_hosts)
        assert got.uids == want.uids
        for field in ("x", "y", "y39", "start", "finish"):
            for a, b in zip(getattr(got, field), getattr(want, field)):
                np.testing.assert_array_equal(a, b)
    assert multihost.host_shard(ds, process_id=0, process_count=1) is ds
    assert multihost.host_shard(ds) is ds  # no process group: a world of one


def test_initialize_noop_paths():
    """One process and no coordinator: nothing to build, as in the JAX
    package; a world of several ranks without one is refused."""
    for kw in ({}, {"num_processes": 1}):
        multihost.initialize(**kw)
        jmultihost.initialize(**kw)
        assert not dist.is_initialized() and jax.process_count() == 1
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(num_processes=2, process_id=0)


def test_pad_batch_to_matches_jax():
    tree = {"x": np.arange(12, dtype=np.float32).reshape(3, 4), "n": np.arange(3, dtype=np.int32)}
    got, n = mesh_lib.pad_batch_to(tree, 4)
    want, jn = jmesh.pad_batch_to(tree, 4)
    assert n == jn == 3
    for k in tree:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    same, _ = mesh_lib.pad_batch_to(tree, 3)
    assert same["x"] is tree["x"]


def test_mesh_shards_match_jax_shardings():
    """Each rank's shard_batch and shard_positions of a global array are
    the JAX shardings' shards of the device at the same (dp, sp) place of
    a (2, 2) mesh; put_batch takes every leaf's rows."""
    a = np.arange(4 * 8 * 3, dtype=np.float32).reshape(4, 8, 3)
    jm = jmake_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    rows = jax.device_put(a, jmesh.batch_sharding(jm))
    both = jax.device_put(a, jmesh.annotation_sharding(jm))
    for r in range(4):
        mesh = mesh_lib.Mesh(dp=2, sp=2, rank=r, device=torch.device("cpu"),
                             groups={"dp": None, "sp": None, "world": None})
        dev = jm.devices[mesh.dp_rank, mesh.sp_rank]
        want_rows = next(s.data for s in rows.addressable_shards if s.device == dev)
        want_both = next(s.data for s in both.addressable_shards if s.device == dev)
        got = mesh_lib.shard_batch(mesh, a)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_rows))
        np.testing.assert_array_equal(mesh_lib.shard_positions(mesh, got).numpy(),
                                      np.asarray(want_both))
        tree = mesh_lib.put_batch(mesh, {"a": a, "n": np.arange(4)})
        assert tree["n"].tolist() == [2 * mesh.dp_rank, 2 * mesh.dp_rank + 1]
    with pytest.raises(ValueError):
        mesh_lib.shard_batch(mesh, a[:3])
    with pytest.raises(ValueError):
        mesh_lib.shard_positions(mesh, got[:, :7])


def test_world_of_one():
    """make_mesh with no process group: a world of one rank, no groups,
    every collective the identity; a mesh larger than the world refused;
    global_batch and put_replicated put the local arrays on the device."""
    mesh = make_mesh(dp=1, device="cpu")
    assert (mesh.shape, mesh.rank, mesh.world, mesh.sp_group) == ({"dp": 1, "sp": 1}, 0, None,
                                                                  None)
    for dp, sp in ((2, 1), (None, 2), (1, 2)):
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(dp=dp, sp=sp, device="cpu")
    local = {"x": np.ones((2, 3), np.float32), "y": np.arange(2)}
    got = multihost.global_batch(mesh, local)
    assert got["x"].device.type == "cpu" and got["y"].tolist() == [0, 1]
    rep = mesh_lib.put_replicated(mesh, {"w": np.full((2,), 3.0, np.float32), "k": 7})
    assert rep["w"].tolist() == [3.0, 3.0] and rep["k"] == 7


def test_spawn_time_limit_and_errors():
    """A hung collective fails within the world's time limit, a rank's
    error comes back with its traceback, and no rank outlives the call."""
    with pytest.raises(TimeoutError):
        multihost.spawn(torch_ranks.hang, 2, 60, timeout=4.0)
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        multihost.spawn(torch_ranks.fail, 2, timeout=60.0)
    assert not multiprocessing.active_children()


def test_run_cli_dp2_under_two_ranks(tmp_path):
    """run_cli --cpu --dp 2 under two gloo ranks: the single-rank run's
    rows (its ragged batches of 1 padded to 2 with a dead row), on both
    ranks, and rank 0 alone the chief; --dp 1 with no launcher is a world
    of one rank, the single-rank rows bit for bit."""
    pytest.importorskip("h5py")
    train, valid, _ = synthetic.train_valid(4, 3, n_phones=5, feat_dim=123, min_len=2,
                                            max_len=4, frames_per_phone=(2, 4), noise=0.2,
                                            seed=0)
    data = tmp_path / "data"
    data.mkdir()
    timit.save_hdf5(train, str(data / "train.h5"))
    timit.save_hdf5(valid, str(data / "valid.h5"))
    argv = ["--cpu", "--data", str(data), "--epochs", "1"]
    single = experiment.run_cli(experiment.scriptchecker, "scriptchecker",
                                argv + ["--save", str(tmp_path / "single")]).log.rows
    one = experiment.run_cli(experiment.scriptchecker, "scriptchecker",
                             argv + ["--dp", "1", "--save", str(tmp_path / "one")])
    assert one.mesh.shape == {"dp": 1, "sp": 1}
    keys = ("train_loss", "train_nll", "valid_nll", "valid_accuracy", "valid_per")
    assert [{k: r[k] for k in keys} for r in one.log.rows] == [{k: r[k] for k in keys}
                                                               for r in single]
    ranks = multihost.spawn(torch_ranks.run_cli_rank, 2,
                            argv + ["--dp", "2", "--save", str(tmp_path / "dp2")], timeout=120.0)
    assert [r["chief"] for r in ranks] == [True, False]
    for r in ranks:
        assert r["shape"] == {"dp": 2, "sp": 1} and len(r["rows"]) == len(single)
        for got, want in zip(r["rows"], single):
            for k in ("train_loss", "train_nll", "valid_nll"):
                assert got[k] == pytest.approx(want[k], rel=2e-4), k
            for k in ("valid_accuracy", "valid_per"):
                assert got[k] == pytest.approx(want[k], abs=1e-6), k
