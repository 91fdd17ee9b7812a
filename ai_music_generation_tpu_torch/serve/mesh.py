"""The sharded servers' control plane: one process per card, rank 0 the
controller (the JAX engines run one controller over every device,
``serve/engine.py:315-368``, ``serve/tunes_engine.py:133-183``).

Every rank of a (data, model) ``DeviceMesh`` (``parallel/mesh.py::
make_mesh``) builds the same engine. Rank 0 alone takes requests, keeps the
queue and the slot table and demultiplexes the tokens. Each step it
broadcasts one control packet, the step's packed host upload with a small
header, and every rank applies it to its own slot rows (``n_slots /
n_data`` of them, its data shard) and runs the step's ticks; the tokens
come back to rank 0 in one fixed-shape gather. The other ranks run the
engine's ``follow()`` loop until the stop packet.

The packets ride a gloo group of their own with a long timeout: a follower
waits in that broadcast while the server is idle, which may be longer than
the process group's timeout; the device group (NCCL on the cards) carries
only the step's collectives, which every rank reaches within the step.
"""

from __future__ import annotations

import datetime
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ai_music_generation_tpu_torch.parallel.mesh import Layout

# how long a follower may wait for the next packet: an idle server sends none
CONTROL_TIMEOUT = datetime.timedelta(days=30)
STEP, STOP = 0, 1
_HEADER = 16  # op, number of arrays, 4 extra ints, then (rows, cols) each


class MeshLink:
    """This rank's side of the control plane over ``mesh`` for an engine of
    ``n_slots`` slots. With ``even`` a slot count that the data axis does
    not divide raises (the GPT engine, as JAX); without, such a count is
    run whole by every data rank (the TunesFormer engine, whose patch cache
    JAX shards only when the axis divides it)."""

    def __init__(self, mesh, n_slots: int, even: bool = True):
        self.layout = lay = Layout(mesh)
        if even and n_slots % lay.n_data:
            raise ValueError(
                f"n_slots={n_slots} must divide evenly over the data axis "
                f"({lay.n_data}) for sharded serving")
        self.sharded = n_slots % lay.n_data == 0
        self.rows = n_slots // lay.n_data if self.sharded else n_slots
        self.base = lay.data_rank * self.rows if self.sharded else 0
        self.controller = dist.get_rank() == 0
        self.control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)

    def mine(self, slots: np.ndarray, device):
        """The positions in ``slots`` (global slot numbers) of this rank's
        rows: a slice when they are contiguous (free slots fill in order,
        and one process holds them all), else a device index; None when
        there are none."""
        keep = np.flatnonzero((slots >= self.base)
                              & (slots < self.base + self.rows))
        if not len(keep):
            return None
        if keep[-1] - keep[0] + 1 == len(keep):
            return slice(int(keep[0]), int(keep[-1]) + 1)
        return torch.from_numpy(keep).to(device)

    def send(self, op: int, arrays: Sequence[np.ndarray] = (),
             extra: Sequence[int] = ()) -> None:
        """Rank 0: broadcast one packet (``arrays``: 2-D int32)."""
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[0], header[1] = op, len(arrays)
        header[2:2 + len(extra)] = torch.tensor(list(extra), dtype=torch.int64)
        for i, a in enumerate(arrays):
            header[6 + 2 * i], header[7 + 2 * i] = a.shape
        dist.broadcast(header, src=0, group=self.control)
        if arrays and sum(a.size for a in arrays):
            flat = torch.from_numpy(np.concatenate(
                [np.ascontiguousarray(a, np.int32).reshape(-1)
                 for a in arrays]))
            dist.broadcast(flat, src=0, group=self.control)

    def recv(self) -> tuple[int, list[np.ndarray], list[int]]:
        """The other ranks: (op, arrays, extra) of the next packet."""
        header = torch.zeros(_HEADER, dtype=torch.int64)
        dist.broadcast(header, src=0, group=self.control)
        op, n = int(header[0]), int(header[1])
        shapes = [(int(header[6 + 2 * i]), int(header[7 + 2 * i]))
                  for i in range(n)]
        flat = torch.zeros(sum(r * c for r, c in shapes), dtype=torch.int32)
        if flat.numel():
            dist.broadcast(flat, src=0, group=self.control)
        arrays, at = [], 0
        for r, c in shapes:
            arrays.append(flat[at:at + r * c].numpy().reshape(r, c))
            at += r * c
        return op, arrays, [int(v) for v in header[2:6]]

    def gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole slot dimension ``dim`` from every data rank's
        ``local`` rows (each data rank's model-rank-0 copy, in data order),
        on every rank; ``local`` itself when every rank ran all rows."""
        if not self.sharded:
            return local
        x = local.to(torch.int32).contiguous()
        world = dist.get_world_size()
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        parts = out.view(world, *x.shape)[::self.layout.n_model]
        return torch.cat(list(parts), dim=dim).to(local.dtype)
