"""Preemption on a 2-rank gloo mesh (dp 2) on the CPU: ``torchrun``
forwards a SIGTERM to every rank, and each rank's guard may see it at a
different step boundary, so the ranks reduce the stop flag at each boundary.
Here one rank alone is signalled (at step 2, off the save cadence): both
ranks stop at step 2, one checkpoint file is written (rank 0's, the dp=1
file), and the mesh's resumed run ends on a checkpoint bitwise the
uninterrupted mesh run's, tensor by tensor."""

import warnings

import pytest
import torch

import torch_sp_workers as workers
from orion_tpu_torch.models.configs import ModelConfig
from orion_tpu_torch.parallel.mesh import MeshConfig
from orion_tpu_torch.training.checkpoint import step_path

pytestmark = pytest.mark.chaos
torch.set_num_threads(2)

TINY = ModelConfig(name="chaos_tiny", vocab_size=32, d_model=16, n_layers=1, n_heads=2,
                   max_seq_len=32, dtype="float32")


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_sigterm_on_one_rank_stops_the_mesh_at_one_step(tmp_path):
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    kw = dict(steps=4, batch_size=4, seq_len=16, lr=1e-3, warmup_steps=2, log_every=1,
              ckpt_every=100, preempt_grace=30.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ranks = workers.run_ranks(2, workers.preempt_runs,
                                  {"mesh": MeshConfig(dp=2), "model": TINY, "kw": kw,
                                   "dirs": dirs, "at": 2, "signal_rank": 1}, timeout=240)
    for rank, (runs, delivered, files) in enumerate(ranks):
        assert runs == [(None, 4), (2, 2), (None, 4)], (rank, runs)
        assert delivered == (["train.step_boundary@2"] if rank == 1 else []), (rank, delivered)
        assert "step-00000002.pt" in files and sum(f.endswith(".pt") for f in files) == 1, files
    got, want = (torch.load(step_path(d, 4), weights_only=True) for d in reversed(dirs))
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert a.keys() == b.keys()
    for name, t in b.items():
        assert torch.equal(a[name], t), name
