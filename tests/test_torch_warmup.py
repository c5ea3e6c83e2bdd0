"""The port's ``warmup`` (tst_torch.train.pipeline.run_warmup): the report's
keys that still mean something equal tst's, the kernels a config's run
would launch, and a CPU run that builds nothing and says so."""

import json

import pytest

from tst import config as config_mod
from tst.data.adapters import load_benchmark
from tst.train import pipeline as jpipe
from tst_torch import cli
from tst_torch import config as tconfig
from tst_torch.train import pipeline as tpipe

#: the reference's report keys that have a meaning on the port
SHARED = ("model", "k", "seq_len", "n_samples", "target")


def _args(out_dir, *extra):
    return ["model.name=tiny", "model.dtype=float32", "data.bench=synthetic:0.5",
            "data.n=12", "data.k=2", "optim.batch_size=4", "optim.epochs=1",
            f"out_dir={out_dir}", *extra]


@pytest.mark.parametrize("ibp", [False, True])
def test_warmup_cli_cpu_matches_reference_keys(tmp_path, ibp):
    out = tmp_path / "t"
    argv = ["warmup", "--platform", "cpu", "--bench", "synthetic:0.5", "--k", "2",
            "--set", "data.n=12", "--set", "model.name=tiny", "--set", "model.dtype=float32",
            "--set", "optim.batch_size=4", "--set", "optim.epochs=1", "--out", str(out)]
    assert cli.main(argv + (["--ibp"] if ibp else [])) == 0
    got = json.loads((out / "warmup_report.json").read_text())
    assert got["kernels"] == [] and got["library"] is None and "nothing to build" in got["note"]
    want = jpipe.run_warmup(load_benchmark("synthetic:0.5", n=12, seed=0),
                            config_mod.resolve(None, None, _args(tmp_path / "j")), ibp=ibp)
    assert {k: got[k] for k in SHARED} == {k: want[k] for k in SHARED}


@pytest.mark.parametrize("extra,want", [
    ([], tpipe._K1),
    (["model.use_pallas=false"], ()),
    (["optim.pack=true"], tpipe._K1 + tpipe._K1_SEG),
    (["model.quantize=int4", "model.fused_mlp=true"], tpipe._K1 + tpipe._K3 + tpipe._K4),
    (["model.fused_mlp=true", "lora.targets=[\"q_proj\",\"up_proj\"]"], tpipe._K1),
])
def test_warmup_entries_follow_the_config(tmp_path, extra, want):
    assert tuple(tpipe.warmup_entries(tconfig.resolve(None, None, _args(tmp_path, *extra)))) \
        == tuple(want)
