"""The port's subcommands against the JAX package's (CPU).  ``cooling``:
``--resume`` and ``--jobs K`` as mdqtplasmasims_tpu/cli.py:227-236 and
:408-418 give them, and ``--version``.  A chain resumed through
``main([...])`` equals the uninterrupted run bit for bit; the two CLIs
accept the same flags and leave trees with the same file names (the
uniforms differ between the packages, so contents are held in
tests/test_torch_cooling.py with replayed uniforms).  ``three-state``,
``three-state-sweep``, ``frozen-tag`` and ``frozen-tag-sweep``: the flags
of their ``mdqt`` namesakes, run through ``main([...])`` on the CPU; so
do ``transport``, ``transport-sweep``, ``mc-tag`` (with ``--resume`` of a
crashed job) and ``mc-tag-sweep``."""

import glob
import os

import numpy as np
import pytest
import torch

from mdqtplasmasims_tpu import cli as jcli
from mdqtplasmasims_torch import cli as tcli
from mdqtplasmasims_torch.experiments import laser_cooling as tlc

torch.set_num_threads(1)

SMALL = ["--n0", "48", "--sample-freq", "2", "--checkpoint-every-segments",
         "1"]


def _names(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*"), recursive=True) if os.path.isfile(p))


def _last_checkpoint(root):
    (path,) = glob.glob(os.path.join(root, "**", "checkpoint_000005.npz"),
                        recursive=True)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cooling_resumes_through_main(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["cooling", *SMALL, "--device", "cpu"]
    assert tcli.main([*args, "--tmax", "0.008", "--save-directory", a]) == 0
    first = _names(a)
    assert tcli.main([*args, "--tmax", "0.012", "--resume",
                      "--save-directory", a]) == 0
    assert tcli.main([*args, "--tmax", "0.012", "--save-directory", b]) == 0
    assert "[cooling] 1 run on cpu" in capsys.readouterr().out
    assert set(first) < set(_names(a))
    chain, straight = _last_checkpoint(a), _last_checkpoint(b)
    assert sorted(chain) == sorted(straight)
    for k in chain:
        np.testing.assert_array_equal(chain[k], straight[k], err_msg=k)
    for name in ("energies.dat", "statePopulationsVsVTime000002.dat",
                 "ions_timestep000005.dat", "wvFns_timestep000005.dat"):
        (pa,), (pb,) = (glob.glob(os.path.join(r, "**", name),
                                  recursive=True) for r in (a, b))
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), name


def test_cooling_resume_and_jobs_leave_the_jax_clis_tree(tmp_path, capsys):
    """Both CLIs: ``--jobs 2`` to tmax=0.004, then ``--jobs 2 --resume`` to
    0.008; the same job directories and file names."""
    roots = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        root = roots[name] = str(tmp_path / name)
        extra = (["--device", "cpu"] if name == "torch"
                 else ["--fused-interpret", "true", "--use-pallas", "false"])
        for tmax, more in (("0.004", []), ("0.008", ["--resume"])):
            assert main(["cooling", *SMALL, *extra, "--jobs", "2", "--tmax",
                         tmax, "--save-directory", root, *more]) == 0
    out = capsys.readouterr().out
    assert "[cooling] job 2/2" in out and "[cooling] 2 runs on cpu" in out
    got, want = _names(roots["torch"]), _names(roots["jax"])
    assert got == want
    assert {os.path.basename(os.path.dirname(p)) for p in got} == {"job1",
                                                                   "job2"}
    assert sum(p.endswith("checkpoint_000003.npz") for p in got) == 2


def test_jobs_flag_runs_each_job_with_its_own_stream(tmp_path):
    root = str(tmp_path)
    assert tcli.main(["cooling", *SMALL, "--device", "cpu", "--jobs", "2",
                      "--tmax", "0.004", "--save-directory", root]) == 0
    cks = sorted(glob.glob(os.path.join(root, "**", "checkpoint_000001.npz"),
                           recursive=True))
    assert len(cks) == 2
    with np.load(cks[0]) as z0, np.load(cks[1]) as z1:
        assert not np.array_equal(z0["R"], z1["R"])
    # job 1 of --jobs equals a plain --job 1 run
    final, _ = tlc.run(tlc.CoolingConfig(n0=48, sample_freq=2, tmax=0.004,
                                         job=1), device="cpu")
    with np.load(sorted(glob.glob(os.path.join(
            root, "**", "job1", "checkpoint_000001.npz"),
            recursive=True))[0]) as z:
        np.testing.assert_array_equal(z["R"], final.R)


@pytest.mark.parametrize("main,prog", [(tcli.main, "mdqt-torch"),
                                       (jcli.main, "mdqt")])
def test_version_flag(main, prog, capsys):
    with pytest.raises(SystemExit) as done:
        main(["--version"])
    assert done.value.code == 0
    out = capsys.readouterr().out.split()
    assert out[0] == prog and out[1][0].isdigit()


# ---- the three-state and frozen-start tagging commands
# (tests/test_misc.py TestSweepCLI, run on the port's CLI)

TOY = ["--n0", "16", "--tmax", "2", "--sample-freq", "100",
       "--dispatch-segments", "5", "--device", "cpu"]
TAG = ["--n0", "24", "--tstart", "0.02", "--tmax", "0.1", "--sample-freq",
       "4", "--tpump-seconds", "5e-8", "--device", "cpu"]


def test_three_state_sweep_end_to_end(tmp_path, capsys):
    """Grid parsing, run_sweep dispatch, per-point directory writes."""
    assert tcli.main(["three-state-sweep", *TOY, "--det-values=-0.5,-2.0",
                      "--om-values", "1.0", "--save-directory",
                      str(tmp_path)]) == 0
    files = glob.glob(str(tmp_path / "Om*" / "Det*" / "job1"
                          / "energies.dat"))
    assert len(files) == 2, files
    assert "2 points x 1 jobs in one fold on cpu" in capsys.readouterr().out


def test_three_state_mesh_flag_end_to_end(tmp_path):
    """--mesh-ens routes the sweep through member_sharded: the same rows
    as the single fold, bit for bit."""
    argv = ["three-state-sweep", *TOY, "--det-values=-0.5,-2.0",
            "--om-values", "1.0"]
    a, b = tmp_path / "a", tmp_path / "b"
    assert tcli.main(argv + ["--save-directory", str(a)]) == 0
    assert tcli.main(argv + ["--save-directory", str(b), "--mesh-ens",
                             "2"]) == 0
    fa = sorted(glob.glob(str(a / "Om*" / "Det*" / "job1" / "energies.dat")))
    fb = sorted(glob.glob(str(b / "Om*" / "Det*" / "job1" / "energies.dat")))
    assert len(fa) == len(fb) == 2
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(np.loadtxt(x), np.loadtxt(y))


@pytest.mark.parametrize("flags,jobs", [([], 1), (["--jobs", "2"], 2),
                                        (["--batch-jobs", "2"], 2),
                                        (["--batch-jobs", "2", "--mesh-ens",
                                          "2"], 2)])
def test_three_state_command(flags, jobs, tmp_path, capsys):
    assert tcli.main(["three-state", *TOY, *flags, "--save-directory",
                      str(tmp_path)]) == 0
    files = glob.glob(str(tmp_path / "Om50" / "Det*" / "job*"
                          / "energies.dat"))
    assert len(files) == jobs
    assert np.loadtxt(files[0]).shape == (2, 2)
    assert "[three-state]" in capsys.readouterr().out


def test_frozen_tag_command_jobs_batch_and_resume(tmp_path, capsys):
    """``frozen-tag``: ``--jobs`` one after the other, ``--resume`` per
    job to a longer tmax, ``--batch-jobs`` as one Poissonian fold."""
    root = str(tmp_path / "seq")
    assert tcli.main(["frozen-tag", *TAG, "--jobs", "2", "--save-directory",
                      root]) == 0
    rows = [np.loadtxt(p).shape[0] for p in sorted(glob.glob(
        os.path.join(root, "*", "job*", "energies.dat")))]
    assert rows == [3, 3]
    argv = ["frozen-tag", *TAG, "--jobs", "2", "--resume",
            "--save-directory", root]
    argv[argv.index("--tmax") + 1] = "0.13"
    assert tcli.main(argv) == 0
    rows = [np.loadtxt(p).shape[0] for p in sorted(glob.glob(
        os.path.join(root, "*", "job*", "energies.dat")))]
    assert rows == [7, 7]
    assert len(glob.glob(os.path.join(root, "*", "job*",
                                      "checkpoint_000064.npz"))) == 2
    fold = str(tmp_path / "fold")
    assert tcli.main(["frozen-tag", *TAG, "--batch-jobs", "3", "--exact-n",
                      "false", "--variant", "408quad", "--save-directory",
                      fold]) == 0
    assert len(glob.glob(os.path.join(fold, "*", "job*",
                                      "vSquareAutoCorr.dat"))) == 3
    out = capsys.readouterr().out
    assert "[frozen-tag] job 2/2" in out and "3 batched trajectories" in out


def test_frozen_tag_sweep_command(tmp_path):
    assert tcli.main(["frozen-tag-sweep", *TAG, "--det-values=-1,-3",
                      "--om-values", "1.3,0.7", "--cross",
                      "--jobs-per-point", "2", "--seed", "5", "--mesh-ens",
                      "2", "--save-directory", str(tmp_path)]) == 0
    dirs = sorted(os.path.basename(d) for d in glob.glob(str(tmp_path / "*")))
    assert len(dirs) == 4 and all("Det" in d and "Om" in d for d in dirs)
    assert len(glob.glob(str(tmp_path / "*" / "job[12]" / "VAF.dat"))) == 8
    with pytest.raises(SystemExit):
        tcli.main(["frozen-tag-sweep", *TAG])          # no grid given


def _flags(main, argv):
    """The option strings a CLI's subcommand accepts (from the usage block
    of its --help: the help texts may break a flag they mention)."""
    import contextlib
    import io
    import re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(argv + ["--help"])
    return set(re.findall(r"--[a-z0-9-]+", buf.getvalue().split("\n\n")[0]))


@pytest.mark.parametrize("cmd", ["three-state", "three-state-sweep",
                                 "frozen-tag", "frozen-tag-sweep",
                                 "transport", "transport-sweep", "mc-tag",
                                 "mc-tag-sweep"])
def test_new_commands_accept_the_jax_clis_flags(cmd):
    """Every flag of the ``mdqt`` namesake is a flag of ``mdqt-torch``,
    which adds ``--device`` (default cuda)."""
    ours, theirs = _flags(tcli.main, [cmd]), _flags(jcli.main, [cmd])
    assert theirs <= ours, sorted(theirs - ours)
    assert ours - theirs == {"--device"}
    job = {"--jobs", "--batch-jobs", "--resume", "--mesh-ens"}
    wanted = {"three-state": job - {"--resume"}, "frozen-tag": job,
              "transport": job, "mc-tag": job,
              "transport-sweep": {"--gamma-values", "--kappa-values",
                                  "--cross", "--jobs-per-point", "--seed",
                                  "--mesh-ens"}}.get(
        cmd, {"--det-values", "--om-values", "--cross", "--jobs-per-point",
              "--seed", "--mesh-ens"})
    assert wanted <= ours
    if not torch.cuda.is_available():          # the default device is cuda
        size = (["--n", "8"] if cmd.startswith(("transport", "mc-tag"))
                else ["--n0", "8", "--tmax", "1"])
        grid = {"transport-sweep": ["--gamma-values", "1"]}.get(
            cmd, ["--det-values=-1"] if cmd.endswith("sweep") else [])
        with pytest.raises((RuntimeError, AssertionError)):
            tcli.main([cmd, *size, *grid])


# ---- the Monte-Carlo families' commands

TRANSPORT = ["--n", "27", "--mc-steps", "200", "--gr-every-mc", "100",
             "--pre-record-md-steps", "5", "--record-steps", "20",
             "--gr-every-record", "10", "--instant-aniso-steps", "5",
             "--reequil-steps", "5", "--aniso-relax-steps", "5",
             "--aniso-time-us", "0.1", "--device", "cpu"]
MCTAG = ["--variant", "422linear", "--n", "27", "--mc-steps", "200",
         "--mc-chunk-steps", "100", "--pre-record-md-steps", "5",
         "--record-steps", "20", "--gr-every-record", "10",
         "--tpump-seconds", "2e-8", "--device", "cpu"]


def test_transport_batch_jobs_and_sweep(tmp_path, capsys):
    root = str(tmp_path / "fold")
    assert tcli.main(["transport", *TRANSPORT, "--batch-jobs", "2",
                      "--save-directory", root]) == 0
    vafs = sorted(glob.glob(os.path.join(root, "*", "job*", "VAF.dat")))
    assert len(vafs) == 2 and np.loadtxt(vafs[0]).shape == (20, 2)
    assert not np.array_equal(np.loadtxt(vafs[0]), np.loadtxt(vafs[1]))
    sweep = str(tmp_path / "sweep")
    assert tcli.main(["transport-sweep", *TRANSPORT, "--gamma-values",
                      "1,3", "--kappa-values", "0.5,1", "--cross",
                      "--save-directory", sweep]) == 0
    dirs = sorted(os.path.basename(d) for d in glob.glob(sweep + "/*"))
    assert dirs == ["Gamma100Kappa100NumIons27", "Gamma100Kappa50NumIons27",
                    "Gamma300Kappa100NumIons27", "Gamma300Kappa50NumIons27"]
    out = capsys.readouterr().out
    assert "2 batched trajectories" in out and "4 points x 1 jobs" in out
    with pytest.raises(SystemExit):       # a fold publishes no checkpoint
        tcli.main(["transport", *TRANSPORT, "--batch-jobs", "2",
                   "--resume", "--save-directory", root])


def test_mc_tag_sweep_and_resume(tmp_path, capsys):
    """``mc-tag-sweep --det-values=-1,0`` writes one tree per point;
    ``mc-tag --resume`` continues a crashed job and ends with the
    uninterrupted job's tree, byte for byte."""
    from mdqtplasmasims_torch.core.pipeline import PipelinePublisher
    sweep = str(tmp_path / "sweep")
    assert tcli.main(["mc-tag-sweep", *MCTAG, "--det-values=-1,0",
                      "--save-directory", sweep]) == 0
    assert len(glob.glob(os.path.join(sweep, "*", "job1",
                                      "taggedMoments.dat"))) == 2
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["mc-tag", *MCTAG, "--checkpoint-every-chunks", "1", "--job", "2"]
    assert tcli.main([*args, "--save-directory", a]) == 0
    real = PipelinePublisher.save

    def crashing(self, *x, **kw):            # a walltime kill mid-pump
        real(self, *x, **kw)
        if self.seq == 6:
            raise RuntimeError("killed")
    PipelinePublisher.save = crashing
    try:
        with pytest.raises(RuntimeError, match="killed"):
            tcli.main([*args, "--save-directory", b])
    finally:
        PipelinePublisher.save = real
    assert not glob.glob(os.path.join(b, "**", "taggedMoments.dat"),
                         recursive=True)
    assert tcli.main([*args, "--resume", "--save-directory", b]) == 0
    fa, fb = _names(a), _names(b)
    dats = [n for n in fa if n.endswith(".dat")]
    assert dats == [n for n in fb if n.endswith(".dat")] and dats
    for n in dats:
        with open(os.path.join(a, n), "rb") as x, \
                open(os.path.join(b, n), "rb") as y:
            assert x.read() == y.read(), n
    assert "[mc-tag] 1 run on cpu" in capsys.readouterr().out
