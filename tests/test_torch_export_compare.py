"""The port's ``export`` and ``compare`` against tst's: on the same run
directory, one written by the port's ``diagnose-rf`` and one written by
tst's, both CLIs write byte-equal files: the exported s(x) table, the
debiased split and its audit, and ``parity.json`` (against a kept split in
the package's own jsonl schema with a reference s(x), and against raw
HuggingFace VSI-Bench rows through ``--bench``). ``membership_agreement``
equals tst's on random rankings."""

import json

import numpy as np
import pytest

from tst import cli as jcli
from tst.eval import parity as jparity
from tst_torch import cli
from tst_torch.eval import parity as tparity

RF = ["diagnose-rf", "--k", "3", "--set", "rf.n_estimators=30", "--set", "rf.backend=sklearn",
      "--platform", "cpu"]
CLIS = {"tst": jcli.main, "port": cli.main}


def _vsi_rows(n, seed):
    """Raw HuggingFace-schema VSI-Bench rows with a longest-option shortcut
    on the first 40% (as tests/test_parity_protocol.py stages them)."""
    rng = np.random.default_rng(seed)
    nouns = ["chair", "table", "sofa", "lamp", "window", "door", "shelf"]
    rows = []
    for i in range(n):
        opts = [" ".join(rng.choice(nouns, 2)) for _ in range(4)]
        gold = int(rng.integers(4))
        if i < 0.4 * n:
            opts[gold] += " " + " ".join(rng.choice(nouns, 6))
        rows.append({"id": f"vsi-fixture-{i:05d}", "question_type": "route_planning",
                     "question": f"Which path leads from the {rng.choice(nouns)} to the "
                                 f"{rng.choice(nouns)}?",
                     "options": opts, "ground_truth": "ABCD"[gold],
                     "scene_name": f"scene{i % 7}", "dataset": "fixture",
                     "planted_bias": i < 0.4 * n})
    return [rows[j] for j in rng.permutation(n)]


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """diagnose-rf run directories, written by each package, on the
    synthetic MCQ set and on raw VSI-Bench rows."""
    base = tmp_path_factory.mktemp("runs")
    raw = _vsi_rows(60, seed=1)
    full = _write_jsonl(base / "vsi_full.jsonl", raw)
    _write_jsonl(base / "vsi_kept.jsonl", [r for r in raw if not r["planted_bias"]])
    for origin, main in CLIS.items():
        assert main(RF + ["--bench", "synthetic:0.5", "--set", "data.n=90",
                          "--out", str(base / origin / "synthetic")]) == 0
        assert main(RF + ["--bench", "vsi_bench", "--source", str(full),
                          "--out", str(base / origin / "vsi")]) == 0
    return base


@pytest.mark.parametrize("origin", ["port", "tst"])
@pytest.mark.parametrize("prune_fraction", [None, 0.25])
def test_export_matches_reference(runs, tmp_path, capsys, origin, prune_fraction):
    run_dir = runs / origin / "synthetic"
    extra = [] if prune_fraction is None else ["--prune-fraction", str(prune_fraction)]
    for name, main in CLIS.items():
        assert main(["export", str(run_dir), "--out", str(tmp_path / name), *extra]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out == {"exported_to": str(tmp_path / "port"), "n": 90}
    names = ["sx.jsonl"]
    if prune_fraction:
        names += ["debiased.jsonl", "removed.jsonl", "ibp_audit.json"]
        removed = (tmp_path / "port" / "removed.jsonl").read_text().splitlines()
        assert len(removed) == 1 + 22  # the benchmark's header line, round(0.25 * 90) rows
    else:
        assert not (tmp_path / "port" / "debiased.jsonl").exists()
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "tst" / name).read_bytes()), name


@pytest.mark.parametrize("origin", ["port", "tst"])
@pytest.mark.parametrize("reference", ["jsonl", "raw-vsi"])
def test_compare_matches_reference(runs, tmp_path, capsys, origin, reference):
    """parity.json byte for byte: against the planted-free rows in the
    package's jsonl schema with the other package's s(x) as the reference
    s(x), and against raw VSI-Bench rows parsed by the vsi_bench adapter."""
    if reference == "jsonl":
        run_dir = runs / origin / "synthetic"
        lines = (run_dir / "dataset.jsonl").read_text().splitlines()
        header, *ds = [json.loads(x) for x in lines]
        kept = _write_jsonl(tmp_path / "kept.jsonl",
                            [header] + [s for s in ds if not s["meta"]["planted_bias"]])
        other = runs / ("tst" if origin == "port" else "port") / "synthetic"
        args = ["--reference-kept", str(kept), "--reference-sx", str(other / "sx.jsonl")]
    else:
        run_dir = runs / origin / "vsi"
        args = ["--reference-kept", str(runs / "vsi_kept.jsonl"), "--bench", "vsi_bench"]
    for name, main in CLIS.items():
        assert main(["compare", str(run_dir), "--out", str(tmp_path / name), *args]) == 0
    capsys.readouterr()
    got = (tmp_path / "port" / "parity.json").read_bytes()
    assert got == (tmp_path / "tst" / "parity.json").read_bytes()
    report = json.loads(got)
    assert report["removed_f1"] > 0.6 and report["n"] == (90 if reference == "jsonl" else 60)
    assert ("spearman" in report) == (reference == "jsonl")


def test_membership_agreement_matches_reference():
    """Random s(x) with NaN rows and ties against random kept sets: equal
    reports; a kept set that does not partition the rows raises in both."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(3, 60))
        s = rng.random(n).astype(np.float32)
        s[rng.random(n) < 0.2] = 0.5
        s[rng.random(n) < 0.15] = np.nan
        ids = [f"r{i}" for i in range(n)]
        kept = [i for i in ids if rng.random() < 0.6] or ids[:1]
        if len(kept) == n:
            kept = kept[1:]
        assert (tparity.membership_agreement(s, ids, kept)
                == jparity.membership_agreement(s, ids, kept)), trial
    for bad in (["zzz"], ["a", "b"]):
        for mod in (tparity, jparity):
            with pytest.raises(ValueError, match="partition"):
                mod.membership_agreement(np.array([0.1, 0.2]), ["a", "b"], bad)
