"""The port's multi-process smoke (ai_music_generation_tpu_torch/parallel/
worker_smoke.py): two gloo worker processes join one group (process 0 by
arguments, process 1 by the torchrun environment variables), run one
data-parallel GPT train step and an all-reduce; their loss and grad norm
equal ``run_smoke()``'s single-process step over the same global batch
within fp32's 1e-5 of the value, the all-reduce sums the ranks, and only
the main process writes (the counterpart of tests/test_distributed.py).
The workers run with ``--device cpu``; the entry point's default is the
card, and without one it raises rather than fall back to the CPU."""

import pytest
import torch

from ai_music_generation_tpu_torch.parallel import worker_smoke
from ai_music_generation_tpu_torch.parallel.worker_smoke import (
    launch_multiprocess_smoke,
    run_smoke,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    return launch_multiprocess_smoke(str(tmp_path_factory.mktemp("smoke")),
                                     num_processes=2, timeout=240,
                                     device="cpu")


def test_workers_rendezvous(reports):
    assert [r["process_index"] for r in reports] == [0, 1]
    assert all(r["process_count"] == 2 and r["global_devices"] == 2
               and r["n_devices"] == 2 for r in reports)


def test_worker_step_matches_the_single_process_step(reports):
    single = run_smoke("cpu")
    assert single["n_devices"] == 1 and single["psum"] == 0.0
    for r in reports:
        for key in ("loss", "grad_norm"):
            assert abs(r[key] - single[key]) <= 1e-5 * abs(single[key])
        assert r["step"] == single["step"] == 1
    # every rank reports the same global step
    assert reports[0]["loss"] == reports[1]["loss"]


def test_all_reduce_sums_the_ranks_and_one_process_writes(reports):
    assert all(r["psum"] == 1.0 for r in reports)  # 0 + 1
    assert all(r["main_flags"] == ["main_flag_0"] for r in reports)


def test_worker_defaults_to_the_card_and_raises_without_one(monkeypatch,
                                                            tmp_path):
    """``python -m ...worker_smoke`` with no ``--device`` joins over NCCL
    on the card; with no card it raises (as the other entry points do)
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        worker_smoke.main(["--port", str(worker_smoke.free_port()),
                           "--process-id", "0", "--num-processes", "1",
                           "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # nothing ran, nothing written
    with pytest.raises(RuntimeError, match="--device=cpu"):
        run_smoke()
