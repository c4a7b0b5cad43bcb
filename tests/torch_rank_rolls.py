"""Picklable replayed streams for tests/test_torch_mesh_ranks.py: the
mesh's rank processes unpickle them, so they live in a module that
imports no more than torch and numpy."""

import numpy as np
import torch


class ReplayRolls:
    """The uniforms of a seeded numpy generator, drawn call after call."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, n_ticks, npad):
        return torch.from_numpy(self.rng.uniform(
            size=(n_ticks * 5, npad)).astype(np.float32))


class FailOnRank1(ReplayRolls):
    """Raises in mesh rank 1."""

    def __call__(self, n_ticks, npad):
        if torch.distributed.get_rank() == 1:
            raise FloatingPointError("rank 1 failed")
        return super().__call__(n_ticks, npad)
