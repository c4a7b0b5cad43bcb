"""The in-kernel RNG form of the tick kernel on the CPU (its plain twin).

The JAX package's device path draws the jump uniforms inside the kernel
from the TPU's hardware PRNG, whose bits nothing else reproduces; the
port's kernel draws a Threefry-2x32-20 stream instead (core/rng.py,
csrc/fused_ticks.cu).  Held here:

* the torch Threefry is bitwise JAX's ``threefry_2x32`` and Random123's
  known-answer vector;
* an RNG step is bitwise the explicit-rolls step fed the same stream, at
  ``ratio``, 1 and ``ratio-1`` ticks (the split sampling step), and the
  split keeps the word and the absolute tick;
* the stream: 24-bit uniforms in [0, 1), uniform (KS) and uncorrelated
  (lag 1) across lanes and ticks, a function of (word, lane, tick) alone;
* the run's generator gives one word per run and nothing per segment or
  MD step (the port's form of tests/test_fused.py:433-462);
* a resume on the RNG path, off the sample grid, is bitwise the
  uninterrupted run;
* an 8-member fold on the RNG path agrees with the explicit-rolls path in
  distribution: final S/P/D populations and per-axis kinetic energy
  within 4 sigma of the pooled member spread.

The runs here take the in-kernel stream's twin on the CPU through the
``rng_on_cpu`` fixture, which gives the one place the form is chosen
(``laser_cooling._use_internal_rng``) the CUDA rule on the CPU.

Tolerances: bitwise (``torch.equal``) wherever both sides run the same
float32 arithmetic; the statistical bars are stated at each test.
"""

import dataclasses
import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32
from scipy import stats

from mdqtplasmasims_tpu.levels import sr12_cooling, with_recoil
from mdqtplasmasims_torch.core import qt_fused as tf
from mdqtplasmasims_torch.core.rng import threefry2x32, tick_uniforms
from mdqtplasmasims_torch.core.scheduler import draw_seed_word
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

from test_torch_fused import C1, C2, G2E, H, P2Q, QDT, _planes
from test_torch_resume import STATE_KEYS, _assert_chain_equals_straight

torch.set_num_threads(1)

WORD = 1234567891


@pytest.fixture
def rng_on_cpu(monkeypatch):
    """CPU runs without a ``rolls_fn`` take the in-kernel stream (its
    twin), as CUDA runs take the kernel."""
    monkeypatch.setattr(tlc, "_use_internal_rng",
                        lambda device, rolls_fn: rolls_fn is None)


def test_threefry_known_answer():
    """Random123's threefry2x32_20 vector (kat_vectors): key (0x13198a2e,
    0x03707344), counter (0x243f6a88, 0x85a308d3)."""
    want = (0xc4923a9c, 0x483df7a0)
    assert threefry2x32(0x13198a2e, 0x03707344, 0x243f6a88,
                        0x85a308d3) == want
    got = threefry_2x32(jnp.asarray([0x13198a2e, 0x03707344], jnp.uint32),
                        jnp.asarray([0x243f6a88, 0x85a308d3], jnp.uint32))
    assert tuple(int(x) for x in got) == want


@pytest.mark.parametrize("case", range(4))
def test_threefry_matches_jax(case):
    rng = np.random.default_rng(case)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64)
    c = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64)
    # JAX splits an even-length count into its x0 and x1 halves
    j = np.asarray(threefry_2x32(jnp.asarray(k.astype(np.uint32)),
                                 jnp.asarray(c.reshape(-1).astype(np.uint32))))
    y0, y1 = threefry2x32(int(k[0]), int(k[1]),
                          torch.from_numpy(c[0].astype(np.int64)),
                          torch.from_numpy(c[1].astype(np.int64)))
    np.testing.assert_array_equal(y0.numpy(), j[:4096].astype(np.int64))
    np.testing.assert_array_equal(y1.numpy(), j[4096:].astype(np.int64))


def _specs(ratio):
    scheme = with_recoil(sr12_cooling(), 9.1e-4, 3.6e-4)
    base = tf.FusedTickSpec(scheme=scheme, h=H, qdt=QDT, plas_to_quant_vel=P2Q,
                            gamma_to_einstein=G2E, ratio=ratio, L=1.0,
                            apply_force=True, exp_c1=C1, exp_c2=C2)
    return base, dataclasses.replace(base, internal_rng=True)


@pytest.mark.parametrize("n_ticks", [25, 1, 24])
def test_rng_step_equals_explicit_step_fed_the_stream(n_ticks):
    """At ``ratio`` ticks, and at the split sampling step's 1 and
    ``ratio-1`` (which start at the absolute ticks k*ratio and k*ratio+1):
    the RNG twin is bitwise the explicit twin fed ``tick_uniforms``."""
    n, npad = 96, 128
    p, L = _planes(n, npad, 12, 16, n_ticks, True, seed=3)
    explicit, rng_spec = (dataclasses.replace(s, ratio=n_ticks, L=L)
                          for s in _specs(25))
    tick0 = 4000 + (n_ticks == 24)
    seed = torch.tensor([WORD], dtype=torch.int32)
    args = [torch.from_numpy(p[k]) for k in ("R", "V", "F", "tp", "psi_re",
                                             "psi_im")]
    a = tf.fused_md_substeps(rng_spec, False, *args, tick0=tick0, seed=seed)
    rolls = tick_uniforms(WORD, tick0, n_ticks, npad)
    b = tf.fused_md_substeps(explicit, False, *args, rolls, tick0=tick0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    if n_ticks == 25:        # the collapse path ran
        assert int((a[2][0, :n] < n_ticks * QDT).sum()) >= 5


def test_split_step_keeps_word_and_tick():
    """[1 tick | ratio-1 ticks] from the same word and the absolute tick
    equals one ratio-tick launch, bitwise."""
    n, npad = 96, 128
    p, L = _planes(n, npad, 12, 16, 25, True, seed=4)
    _, spec = (dataclasses.replace(s, L=L) for s in _specs(25))
    seed = torch.tensor([WORD], dtype=torch.int32)
    args = [torch.from_numpy(p[k]) for k in ("R", "V", "F", "tp", "psi_re",
                                             "psi_im")]
    whole = tf.fused_md_substeps(spec, False, *args, tick0=2500, seed=seed)
    R, V, tp, a, b = tf.fused_md_substeps(
        dataclasses.replace(spec, ratio=1), False, *args, tick0=2500,
        seed=seed)
    split = tf.fused_md_substeps(dataclasses.replace(spec, ratio=24), False,
                                 R, V, args[2], tp, a, b, tick0=2501,
                                 seed=seed)
    for x, y in zip(whole, split):
        assert torch.equal(x, y)


def test_form_arguments_are_checked():
    n, npad = 96, 128
    p, L = _planes(n, npad, 12, 16, 25, False, seed=5)
    explicit, spec = _specs(25)
    args = [torch.from_numpy(p[k]) for k in ("R", "V", "F", "tp", "psi_re",
                                             "psi_im")]
    rolls = torch.from_numpy(p["rolls"])
    seed = torch.tensor([WORD], dtype=torch.int32)
    with pytest.raises(ValueError, match="rolls must be given"):
        tf.fused_md_substeps(spec, False, *args, rolls, seed=seed)
    with pytest.raises(ValueError, match="rolls must be given"):
        tf.fused_md_substeps(explicit, False, *args, seed=seed)
    with pytest.raises(ValueError, match="seed must be given"):
        tf.fused_md_substeps(spec, False, *args)
    with pytest.raises(ValueError, match="seed must be given"):
        tf.fused_md_substeps(explicit, False, *args, rolls, seed=seed)
    with pytest.raises(ValueError, match="int32"):
        tf.fused_md_substeps(spec, False, *args, seed=seed.long())
    # the form follows the device and the rolls_fn alone
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tlc._use_internal_rng(cuda, None)
    assert not tlc._use_internal_rng(cuda, lambda nt, n: None)
    assert not tlc._use_internal_rng(cpu, None)
    assert not tlc.build_scheduler(tlc.CoolingConfig(n0=64), "cpu",
                                   rolls_fn=None).fused_spec.internal_rng


def test_uniforms_unit_interval_and_statistics():
    """1000 x 1024 draws: every value a 24-bit fraction in [0, 1); KS
    against U(0, 1) per uniform row (p > 1e-4), and lag-1 correlations
    along the lanes and along the ticks within 5/sqrt(count)."""
    n_ticks, npad = 200, 1024
    u = tick_uniforms(WORD, 777, n_ticks, npad).numpy().astype(np.float64)
    assert u.shape == (n_ticks * 5, npad)
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_array_equal(u * 2 ** 24, np.floor(u * 2 ** 24))
    per = u.reshape(n_ticks, 5, npad)
    for k in range(5):
        assert stats.kstest(per[:, k].ravel(), "uniform").pvalue > 1e-4, k
    x = per - 0.5
    for a, b in ((x[:, :, 1:], x[:, :, :-1]), (x[1:], x[:-1]),
                 (x[:, 1:], x[:, :-1])):
        r = float(np.mean(a * b) / np.mean(x * x))
        assert abs(r) < 5.0 / np.sqrt(a.size), r


def test_stream_is_a_function_of_word_lane_and_tick():
    u = tick_uniforms(WORD, 1000, 4, 512)
    # the same (word, lane, tick) gives the same bits, whatever the block
    assert torch.equal(u[5:10], tick_uniforms(WORD, 1001, 1, 512))
    assert torch.equal(u[:, :256], tick_uniforms(WORD, 1000, 4, 256))
    # changing any one of them gives new bits
    for other in (tick_uniforms(WORD + 1, 1000, 4, 512), u[:, 1:],
                  tick_uniforms(WORD, 1004, 4, 512)):
        same = float((u[:, :other.shape[1]] == other).float().mean())
        assert same < 1e-3, same
    # the rows of one tick differ from each other
    assert float((u[0] == u[1]).float().mean()) < 1e-3


def _native(root):
    out = {}
    for p in sorted(glob.glob(str(root / "**" / "checkpoint_*.npz"),
                              recursive=True)):
        with np.load(p) as z:
            out[p] = {k: z[k] for k in z.files}
    return out


def test_generator_gives_one_word_per_run(tmp_path, rng_on_cpu):
    """Every native checkpoint of a 3-group run (and of a 2-member fold)
    holds the word and the generator state right after the start and the
    one word: nothing is drawn per segment or MD step."""
    cfg = tlc.CoolingConfig(n0=64, tmax=0.012, sample_freq=2,
                            checkpoint_every_segments=1,
                            save_directory=str(tmp_path / "run"))
    tlc.run(cfg, seed=5, device="cpu")
    g = torch.Generator().manual_seed(5)
    tlc.initial_state(cfg, g)
    word = draw_seed_word(g)
    zs = _native(tmp_path / "run")
    assert len(zs) == 3
    for z in zs.values():
        np.testing.assert_array_equal(z["torch_rng_seed"], word.numpy())
        np.testing.assert_array_equal(z["torch_rng_state"],
                                      g.get_state().numpy())
    fold = dataclasses.replace(cfg, save_directory=str(tmp_path / "fold"))
    tlc.run_ensemble(fold, 2, seed=7, device="cpu")
    g = torch.Generator().manual_seed(tlc.fold_seed(7))
    word = draw_seed_word(g)
    zs = _native(tmp_path / "fold")
    assert len(zs) == 6
    for z in zs.values():
        np.testing.assert_array_equal(z["torch_rng_seed"], word.numpy())
        np.testing.assert_array_equal(z["torch_rng_state"],
                                      g.get_state().numpy())


@pytest.mark.parametrize("family", ["run", "ensemble"])
def test_rng_resume_off_grid_equals_uninterrupted(tmp_path, family,
                                                  rng_on_cpu):
    """5 + 2 MD steps (the first window ends off the grid) against 7
    straight, on the in-kernel stream: the resume reuses the checkpoint's
    word and the absolute tick."""
    base = dict(n0=64, sample_freq=2, checkpoint_every_segments=1)
    cfg = tlc.CoolingConfig(tmax=0.01, exact_n=family == "run",
                            save_directory=str(tmp_path / "a"), **base)
    if family == "run":
        go = lambda c, **kw: tlc.run(c, device="cpu", **kw)[0]
    else:
        go = lambda c, **kw: tlc.run_ensemble(c, 2, seed=6, device="cpu",
                                              **kw)[0]
    go(cfg)
    chain = go(dataclasses.replace(cfg, tmax=0.014), resume=True)
    straight = go(dataclasses.replace(cfg, tmax=0.014,
                                      save_directory=str(tmp_path / "b")))
    for k in STATE_KEYS:
        if family == "run":
            np.testing.assert_array_equal(getattr(chain, k),
                                          getattr(straight, k))
        else:   # real lanes only: a padded lane's clock ticks on
            from mdqtplasmasims_torch.core.init import poisson_member_mask
            for j, nj in enumerate(poisson_member_mask(64, 2, 6)[1]):
                np.testing.assert_array_equal(getattr(chain, k)[j][:nj],
                                              getattr(straight, k)[j][:nj])
    _assert_chain_equals_straight(str(tmp_path / "a"), str(tmp_path / "b"),
                                  6)


def test_rng_fold_agrees_with_explicit_rolls_in_distribution(monkeypatch):
    """Eight N0=64 members from the same starts, 20 MD steps (~5 decay
    times of the P manifold), once on the in-kernel stream and once on explicit
    rolls: per quantity (final S/P/D populations, per-axis kinetic
    energy) the member means differ by less than 4 sigma of the pooled
    member spread, sqrt(var_a/8 + var_b/8)."""
    cfg = tlc.CoolingConfig(n0=64, tmax=0.04, sample_freq=20)
    res = {}
    for rng in (True, False):
        with monkeypatch.context() as m:
            if rng:
                m.setattr(tlc, "_use_internal_rng",
                          lambda device, rolls_fn: rolls_fn is None)
            final, outs = tlc.run_ensemble(cfg, 8, seed=11, device="cpu")
        pops = np.abs(final.psi) ** 2
        res[rng] = np.concatenate([
            np.stack([pops[..., :2].sum(-1).mean(-1),
                      pops[..., 2:6].sum(-1).mean(-1),
                      pops[..., 6:].sum(-1).mean(-1)], -1),
            outs["ekin"][:, -1, :]], -1)                   # [8, 6]
    a, b = res[True], res[False]
    assert not np.allclose(a, b)        # the two streams differ
    sigma = np.sqrt(a.var(0, ddof=1) / 8 + b.var(0, ddof=1) / 8)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 4 * sigma), (
        a.mean(0), b.mean(0), sigma)
    # jumps fired: the P and D manifolds took population from S
    assert a[:, 1].mean() > 0.05 and a[:, 2].mean() > 0.01
