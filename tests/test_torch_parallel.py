"""``satpu_torch.parallel`` against ``satpu.parallel`` on the same inputs:
``pad_batch_to_devices``, the per-host work lists and batch sizes, the
refusal of a minibatch the device count does not divide, satpu's repeat
padding of a short batch; a rank's contiguous block of the global batch
(satpu's ``P("data")`` placement); the environment parsing of
``init_distributed`` (torchrun's variables, satpu's ``SATPU_*`` ones, and
no world: a no-op), and the contiguous split and in-order gather of a
serving batch."""
import numpy as np
import pytest
import torch

import jax

from satpu.parallel import mesh as jmesh
from satpu.parallel import multihost as jhost
from satpu_torch.parallel import mesh, multihost


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_pad_batch_and_repeat_padding_match_satpu(n):
    for b in range(1, 20):
        assert mesh.pad_batch_to_devices(b, n) == jmesh.pad_batch_to_devices(b, n)
        # satpu/bin/train_asr.py:326-334
        want = (np.arange(jmesh.pad_batch_to_devices(b, n)) % b) if b % n else None
        got = mesh.repeat_pad_rows(b, n)
        assert (got is None) == (want is None) and (got is None or list(want) == got)


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_host_shards_and_local_batch_match_satpu(count):
    items = [f"utt{i}" for i in range(11)]
    for p in range(count):
        assert (multihost.host_shard_list(items, p, count)
                == jhost.host_shard_list(items, p, count))
    for g in (4, 6, 15, 30):
        if g % count:
            with pytest.raises(AssertionError):
                jhost.host_local_batch_size(g, count)
            with pytest.raises(ValueError, match="not divisible"):
                multihost.host_local_batch_size(g, count)
        else:
            assert multihost.host_local_batch_size(g, count) == jhost.host_local_batch_size(
                g, count)
    # no process group: process 0 of 1
    assert multihost.host_shard_list(items) == items
    assert multihost.host_local_batch_size(6) == 6


def test_divisibility_refusal_matches_satpu():
    cpu = jax.devices("cpu")[0]
    with pytest.raises(ValueError, match="divisible by the local device count 2") as jerr:
        jmesh.local_data_mesh(5, devices=[cpu, cpu])
    with pytest.raises(ValueError, match="divisible by the device count 2") as err:
        mesh.check_batch_divisible(5, 2)
    assert "pad to 6" in str(jerr.value) and "pad to 6" in str(err.value)
    mesh.check_batch_divisible(6, 2)
    mesh.check_batch_divisible(5, 1)


def test_local_batch_slice_is_satpus_data_placement():
    """Device k of satpu's ``P("data")`` sharding holds rows [k B/n, (k+1) B/n)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    cpu = jax.devices("cpu")[0]
    jm = Mesh(np.array([cpu]), ("data",))
    x = jax.device_put(np.arange(12), NamedSharding(jm, PartitionSpec("data")))
    assert x.addressable_shards[0].index == (slice(None, None, None),)  # one device
    for n in (1, 2, 3, 4, 6):
        rows = [list(range(12)[mesh.local_batch_slice(12, r, n)]) for r in range(n)]
        assert sum(rows, []) == list(range(12)) and len({len(r) for r in rows}) == 1
    with pytest.raises(ValueError):
        mesh.local_batch_slice(7, 0, 2)


def test_init_distributed_env(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SATPU_COORDINATOR",
              "SATPU_NUM_PROCESSES", "SATPU_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    # no world configured: nothing happens, as satpu's
    assert multihost._world_from_env() is None
    assert multihost.configured_world_size() == 1
    assert multihost.init_distributed("cpu") == 1
    assert not torch.distributed.is_initialized()
    assert mesh.world() == 1 and mesh.rank() == 0
    assert multihost.local_device("cpu") == torch.device("cpu")
    # satpu's launch variables
    monkeypatch.setenv("SATPU_COORDINATOR", "host0:1234")
    monkeypatch.setenv("SATPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("SATPU_PROCESS_ID", "2")
    assert multihost._world_from_env() == ("tcp://host0:1234", 4, 2)
    # torchrun's take precedence
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29501")
    assert multihost._world_from_env() == ("tcp://10.0.0.1:29501", 2, 1)
    assert multihost.configured_world_size() == 2
    # a one-process world is no world
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert multihost.init_distributed("cpu") == 1 and not torch.distributed.is_initialized()
    # rank r drives cuda:LOCAL_RANK (not on the CPU)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.local_device("cpu") == torch.device("cpu")


def test_one_rank_gloo_group(tmp_path):
    """A real group of one (gloo over a free port): the collectives are the
    identity, and the context tears down only the group it started."""
    from torch_dp_worker import free_port

    with multihost.distributed("cpu") as world:
        assert world == 1 and not torch.distributed.is_initialized()
    multihost.init_distributed("cpu", f"localhost:{free_port()}", 1, 0)
    assert not torch.distributed.is_initialized()  # a one-process world is none
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                                         world_size=1, rank=0)
    try:
        with multihost.distributed("cpu") as world:
            assert world == 1
            t = torch.arange(4.0)
            assert torch.equal(mesh.all_reduce_(t.clone()), t)
            s = mesh.sum_metrics({"a": torch.tensor(2.0), "b": torch.tensor(3.0)}, ("b",))
            assert float(s["a"]) == 2.0
        assert torch.distributed.is_initialized()  # the caller's group stays
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()


def test_split_and_gather_rows():
    x = torch.arange(10.0).reshape(5, 2)
    blocks = mesh.split_rows(x, ["cpu", "cpu"])
    assert [b.shape[0] for b in blocks] == [3, 2]
    assert torch.equal(mesh.gather_rows(blocks), x)
    assert [b.shape[0] for b in mesh.split_rows(x[:1], ["cpu", "cpu", "cpu"])] == [1]


def test_global_rows_without_group_is_the_plain_draw():
    draw = lambda s: torch.rand(s, generator=torch.Generator().manual_seed(3))  # noqa: E731
    assert torch.equal(mesh.global_rows(draw, (4, 3)), draw((4, 3)))
