"""The port's InteriorNet downloader (cli/download_interior.py) and
`compat.download_trained_weights` against the JAX package's, with no
network: a temporary CSV manifest, and gdown either absent or replaced
by a stand-in that writes a zip from the drive id.

* The printed plan and the created subset directory equal the JAX
  command's for --subset, --limit and --dry-run, blank manifest rows
  skipped.
* Without gdown both commands exit with the same message, after making
  the directory.
* With the stand-in both download, unpack and remove each zip in the
  same order, leaving the same files.
* A subset outside train/val/test and a missing --list are refused by
  both parsers.
* `download_trained_weights` raises NotImplementedError in both; the
  port's message names its h5 route.
"""

import sys
import types
import zipfile

import pytest

pytest.importorskip("torch")

from mulit_view_object_detection_tpu import compat as jax_compat  # noqa: E402
from mulit_view_object_detection_tpu.cli import (  # noqa: E402
    download_interior as jax_download)
from mulit_view_object_detection_torch import compat  # noqa: E402
from mulit_view_object_detection_torch.cli import (  # noqa: E402
    download_interior as download)

ROWS = [("3FO4K5G1L00B", "1aB"), ("3FO4K5I8T7KR", "2cD"),
        ("3FO4K5HSU5QH", "3eF")]


@pytest.fixture
def manifest(tmp_path):
    path = tmp_path / "hd7.csv"
    lines = [f"{s},{d}" for s, d in ROWS]
    path.write_text("\n".join(lines[:1] + [""] + lines[1:]) + "\n")
    return path


def _run(module, tmp_path, name, argv, capsys):
    """`module.main` with --out under tmp_path/name: (what it printed
    with that prefix dropped, the files under the subset directory)."""
    out = tmp_path / name
    module.main(["--out", str(out), *argv])
    printed = capsys.readouterr().out.replace(str(out), "<out>")
    files = sorted(p.relative_to(out).as_posix() for p in out.rglob("*"))
    return printed, files


@pytest.mark.parametrize("argv", [
    [], ["--subset", "val"], ["--subset", "test", "--limit", "2"],
    ["--limit", "1"]], ids=["train", "val", "test_limit2", "limit1"])
def test_dry_run_plan_matches_jax(argv, manifest, tmp_path, capsys):
    argv = ["--list", str(manifest), "--dry-run", *argv]
    got = _run(download, tmp_path, "port", argv, capsys)
    want = _run(jax_download, tmp_path, "jax", argv, capsys)
    assert got == want
    n = min(len(ROWS), int(argv[argv.index("--limit") + 1])
            if "--limit" in argv else len(ROWS))
    subset = argv[argv.index("--subset") + 1] if "--subset" in argv \
        else "train"
    assert got == (f"{n} scenes -> <out>/{subset}\n", [subset])


def test_without_gdown_both_exit_with_the_message(manifest, tmp_path,
                                                  monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gdown", None)   # import raises
    argv = ["--list", str(manifest), "--subset", "val"]
    exits = []
    for module, name in ((download, "port"), (jax_download, "jax")):
        with pytest.raises(SystemExit) as e:
            _run(module, tmp_path, name, argv, capsys)
        exits.append(str(e.value.code))
        assert (tmp_path / name / "val").is_dir()
    assert exits[0] == exits[1] and "gdown is not installed" in exits[0]


def test_downloads_with_a_stand_in_gdown(manifest, tmp_path, monkeypatch,
                                         capsys):
    """No network: gdown.download writes a zip holding the scene's files
    named after the drive id."""
    calls = []

    def fake_download(id, output, quiet):
        calls.append((id, output.rsplit("/", 1)[-1], quiet))
        scene = output.rsplit("/", 1)[-1][:-len(".zip")]
        with zipfile.ZipFile(output, "w") as z:
            z.writestr(f"{scene}/cam0/data/{id}.png", id)
            z.writestr(f"{scene}/cam0.render", "0 0 0")

    monkeypatch.setitem(sys.modules, "gdown",
                        types.SimpleNamespace(download=fake_download))
    argv = ["--list", str(manifest), "--limit", "2"]
    got = _run(download, tmp_path, "port", argv, capsys)
    port_calls, calls[:] = list(calls), []
    want = _run(jax_download, tmp_path, "jax", argv, capsys)
    assert got == want and port_calls == calls
    assert [c[0] for c in calls] == ["1aB", "2cD"]
    assert not any(f.endswith(".zip") for f in got[1])
    assert "train/3FO4K5G1L00B/cam0/data/1aB.png" in got[1]


@pytest.mark.parametrize("argv", [
    ["--list", "x.csv", "--subset", "dev"], ["--subset", "train"]],
    ids=["bad_subset", "no_list"])
def test_both_parsers_refuse(argv, capsys):
    for module in (download, jax_download):
        with pytest.raises(SystemExit) as e:
            module.main(argv)
        assert e.value.code == 2


def test_download_trained_weights_raises_as_jax():
    for fn in (compat.download_trained_weights,
               jax_compat.download_trained_weights):
        with pytest.raises(NotImplementedError, match="mask_rcnn_coco.h5"):
            fn("mask_rcnn_coco.h5", verbose=0)
    with pytest.raises(NotImplementedError, match="h5_import"):
        compat.download_trained_weights("mask_rcnn_coco.h5")
