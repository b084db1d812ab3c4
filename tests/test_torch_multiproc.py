"""parallel.multiproc: the bootstrap's environment and backend rules,
and the launcher's failure propagation (two gloo CPU processes)."""

import pytest
import torch.distributed as dist

import torch_dist_worker
from apex_tpu_torch.parallel import multiproc

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_no_address_or_a_world_of_one_is_a_no_op(clean_env):
    multiproc.initialize_distributed()
    assert not dist.is_initialized()
    clean_env.setenv("MASTER_ADDR", "localhost")
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("RANK", "0")
    multiproc.initialize_distributed()
    assert not dist.is_initialized()
    assert multiproc.world_size() == 1 and multiproc.process_index() == 0
    assert multiproc.is_coordinator() and multiproc.local_rank() == 0


def test_nccl_with_more_ranks_than_cards_raises(clean_env):
    clean_env.setenv("MASTER_ADDR", "localhost")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="NCCL needs a card a rank"):
        multiproc.initialize_distributed(backend="nccl")
    assert not dist.is_initialized()


def test_local_rank_picks_the_device(clean_env):
    clean_env.setenv("LOCAL_RANK", "3")
    assert multiproc.local_rank() == 3
    assert multiproc.device().type in ("cpu", "cuda")


def test_elastic_checkpoint_manager_waits_for_a10():
    with pytest.raises(NotImplementedError, match="A 10"):
        multiproc.elastic_checkpoint_manager("/nonexistent")


def test_launch_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        multiproc.launch(torch_dist_worker.failing_rank, 2, (1,),
                         backend="gloo", threads=1, timeout=120)
    assert "boom on rank 1" in str(err.value)
    assert multiproc.launch(torch_dist_worker.failing_rank, 2, (5,),
                            backend="gloo", threads=1,
                            timeout=120) == [0, 1]
