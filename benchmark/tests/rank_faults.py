"""Faults planted in the rank processes of a mesh cell: the test replaces
``parallel.ranks._cooling_task`` with :func:`task`, which each rank
imports by name; the fault is named by ``BENCH_RANK_FAULT``, which the
rank processes inherit when they start."""

import os

from mdqtplasmasims_torch.parallel import ranks

_ORIGINAL = ranks._cooling_task


def _step_unchanged():
    from mdqtplasmasims_torch.core.scheduler import CoolingScheduler
    CoolingScheduler.soa_md_step = lambda self, carry, *a, **k: carry


def _half_the_ions():
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    ke = lc.kinetic_energies
    lc.kinetic_energies = lambda V, subtract_mean_vx=False, mask=None: ke(
        V[: V.shape[0] // 2], subtract_mean_vx, None)


def _answer_altered():
    from mdqtplasmasims_torch.experiments import laser_cooling as lc
    so = lc._sample_outputs

    def altered(*a, **k):
        out = so(*a, **k)
        out["vx_ions"] = out["vx_ions"].clone()
        out["vx_ions"][0] += 0.5
        return out
    lc._sample_outputs = altered


def _exchange_left_out():
    from mdqtplasmasims_torch.parallel.mesh import join_state

    def join(self, grid):
        # no gather: rank 0 joins its own block into every slot
        if self.rank:
            return None
        b = grid[self.k][self.i]
        return join_state([[b] * self.I] * self.K, self.device)
    ranks.RankComm.join = join


def _last_rank_stale():
    # one rank's block never steps; the others and the gather are sound
    if _ME["rank"] == _ME["world"] - 1:
        _step_unchanged()


_ME = {}
FAULTS = {f.__name__[1:]: f for f in (_step_unchanged, _half_the_ions,
                                      _answer_altered, _exchange_left_out,
                                      _last_rank_stale)}


def task(me, job, block):
    fault = os.environ.get("BENCH_RANK_FAULT")
    if fault:
        _ME.update(rank=me.rank, world=me.world)
        FAULTS[fault]()
    return _ORIGINAL(me, job, block)
