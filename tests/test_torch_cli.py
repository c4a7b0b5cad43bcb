"""The port's ``cooling`` subcommand against the JAX package's (CPU):
``--resume`` and ``--jobs K`` as mdqtplasmasims_tpu/cli.py:227-236 and
:408-418 give them, and ``--version``.  A chain resumed through
``main([...])`` equals the uninterrupted run bit for bit; the two CLIs
accept the same flags and leave trees with the same file names (the
uniforms differ between the packages, so contents are held in
tests/test_torch_cooling.py with replayed uniforms)."""

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
