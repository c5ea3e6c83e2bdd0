"""``tst_torch`` command-line interface (counterpart of ``tst/cli.py``).

Subcommands, every one of ``tst``'s:

  * ``diagnose-rf``    — lightweight Random-Forest shortcut audit
  * ``diagnose-sft``   — k-fold blind LoRA SFT diagnostic (the core method)
  * ``warmup``         — build every CUDA kernel a config's run would launch
  * ``debias-ibp``     — Iterative Bias Pruning → debiased split
  * ``eval-blind``     — blind evaluation, zero-shot or of a trained adapter
                         (``--adapter DIR --fold i|mean``)
  * ``train-transfer`` — fine-tune on a training set, blind-evaluate a test set
  * ``generate``       — greedy continuations (serving; exact speculative
                         decoding with ``--draft-model``)
  * ``export``         — re-emit artifacts from a previous run directory
  * ``compare``        — ranking parity of a run's s(x) vs a reference split

They take the flags of their ``tst`` counterparts and read the same
``RunConfig`` and presets; ``--platform`` is ``gpu`` (the default, also for
``diagnose-rf``: the CUDA device, and an error without one) or ``cpu``;
``export`` and ``compare`` run on the host. Of ``--set perf.*`` only
``perf.spec_draft_*`` and ``perf.spec_gamma`` apply here; the others are TPU
kernel knobs. ``--profile-dir`` traces diagnose-sft's training and scoring
(tst_torch.aux.profile); ``--debug-nans`` raises FloatingPointError at the
first non-finite train loss or adapter gradient (the reference's
``jax_debug_nans``, reached by a finite check on the card).

Run as ``python -m tst_torch <subcommand> ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from tst_torch import config as config_mod
from tst_torch.config import RunConfig
from tst_torch.runtime.device import PLATFORMS, select_device
from tst_torch.runtime.mesh import init_distributed, is_main
from tst_torch.train.sft import set_debug_nans

#: subcommands of ``tst`` that the port does not have yet → ROADMAP item
#: (none since every subcommand is ported)
NOT_PORTED: dict = {}


def _common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--platform", default="gpu", choices=PLATFORMS,
                   help="gpu = the CUDA device (fails without one); cpu = explicit CPU run")
    p.add_argument("--preset", default=None, help=f"one of {sorted(config_mod.PRESETS)}")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override, repeatable")
    p.add_argument("--bench", default=None, help="benchmark name (shorthand for data.bench)")
    p.add_argument("--source", default=None, help="local dataset dir/jsonl (shorthand)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", default=None, help="output directory (shorthand for out_dir)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace of diagnose-sft's training and scoring here "
                        "(trace.json, op_summary.json)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite train loss or "
                        "adapter gradient, naming the step and the fold")


def _resolve(args):
    """(RunConfig, torch.device) from the parsed flags. A launch over several
    ranks (``torchrun --nproc-per-node N python -m tst_torch ...``) joins
    its process group first, so each rank takes its own card."""
    init_distributed()
    device = select_device(args.platform)
    cfg = config_mod.resolve(args.preset, args.config, args.overrides)
    set_debug_nans(bool(getattr(args, "debug_nans", False)))
    if getattr(args, "profile_dir", None):
        cfg.profile_dir = args.profile_dir
    if args.bench is not None:
        cfg.data.bench = args.bench
    if args.source is not None:
        cfg.data.source = args.source
    if args.seed is not None:
        cfg.data.seed = args.seed
    if args.out is not None:
        cfg.out_dir = args.out
    return cfg, device


def _load_dataset(cfg: RunConfig):
    from tst_torch.data.adapters import load_benchmark

    return load_benchmark(
        cfg.data.bench, source=cfg.data.source, split=cfg.data.split,
        include_open=cfg.data.include_open,
        **({"n": cfg.data.n, "seed": cfg.data.seed} if cfg.data.bench.startswith("synthetic") else {}),
    )


def cmd_eval_blind(args) -> int:
    from tst_torch.train.pipeline import run_blind_eval

    cfg, device = _resolve(args)
    ds = _load_dataset(cfg)
    report = run_blind_eval(ds, cfg, device, adapter_dir=args.adapter, fold=args.fold,
                            full_accuracy=args.full_accuracy)
    print(json.dumps(report, indent=2, default=float))
    return 0


def _resolve_k(args):
    cfg, device = _resolve(args)
    if args.k is not None:
        cfg.data.k = args.k
    return cfg, device


def cmd_diagnose_rf(args) -> int:
    from tst_torch.diagnose.rf import run_rf_diagnostic
    from tst_torch.io import outputs

    cfg, device = _resolve_k(args)
    ds = _load_dataset(cfg)
    t0 = time.time()
    d = run_rf_diagnostic(
        ds, k=cfg.data.k, seed=cfg.data.seed,
        n_estimators=cfg.rf.n_estimators, max_depth=cfg.rf.max_depth,
        backend=cfg.rf.backend, score_rule=cfg.rf.score_rule, device=device,
    )
    report = d.report()
    report["wall_seconds"] = round(time.time() - t0, 2)
    report["n_samples"] = len(ds)
    if is_main():  # rank 0 of a launch over several ranks writes
        outputs.write_sx_table(cfg.out_dir, ds, d.s_x, d.fold_id, pred=d.pred)
        outputs.write_report(cfg.out_dir, report)
        ds.save_jsonl(f"{cfg.out_dir}/dataset.jsonl")
        cfg.save(f"{cfg.out_dir}/config.json")
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_diagnose_sft(args) -> int:
    from tst_torch.train.pipeline import run_sft_diagnostic

    cfg, device = _resolve_k(args)
    ds = _load_dataset(cfg)
    report = run_sft_diagnostic(ds, cfg, device)
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_debias_ibp(args) -> int:
    from tst_torch.debias.ibp import run_ibp

    cfg, device = _resolve_k(args)
    ds = _load_dataset(cfg)
    report = run_ibp(ds, cfg, device)
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_warmup(args) -> int:
    """Build every CUDA kernel a diagnose-sft (``--ibp``: debias-ibp) run of
    this config would launch, so the run itself does not pay the build."""
    from tst_torch.train.pipeline import run_warmup

    cfg, device = _resolve_k(args)
    ds = _load_dataset(cfg)
    report = run_warmup(ds, cfg, device, ibp=args.ibp)
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_train_transfer(args) -> int:
    """Fine-tune on a training set, blind-evaluate the test set."""
    from tst_torch.data.adapters import load_benchmark
    from tst_torch.train.transfer import run_train_transfer

    cfg, device = _resolve_k(args)
    eval_ds = _load_dataset(cfg)
    train_ds = load_benchmark(
        args.train_bench, source=args.train_source,
        **({"n": cfg.data.n, "seed": cfg.data.seed + 99}
           if args.train_bench.startswith("synthetic") else {}),
    )
    report = run_train_transfer(train_ds, eval_ds, cfg, device)
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_generate(args) -> int:
    """Greedy continuations of every sample's blind prompt (the serving
    surface); ``--draft-model`` / ``--draft-path`` switch to exact
    speculative decoding, the same tokens with the acceptance reported."""
    from tst_torch.train.pipeline import run_generate

    cfg, device = _resolve_k(args)
    ds = _load_dataset(cfg)
    report = run_generate(
        ds, cfg, device, max_new=args.max_new, draft_model=args.draft_model,
        draft_path=args.draft_path, draft_quantize=args.draft_quantize, gamma=args.gamma,
        adapter_dir=args.adapter, fold=args.fold)
    print(json.dumps(report, indent=2, default=float))
    return 0


def _read_sx(run_dir: str):
    """(ids, s(x) f32 with NaN for null, folds) of a run directory's sx.jsonl."""
    import numpy as np

    ids, sx, fold = [], [], []
    with open(f"{run_dir}/sx.jsonl") as f:
        for line in f:
            row = json.loads(line)
            ids.append(row["id"])
            sx.append(row["s_x"] if row["s_x"] is not None else float("nan"))
            fold.append(row["fold"])
    return ids, np.asarray(sx, np.float32), np.asarray(fold)


def cmd_export(args) -> int:
    """Re-emit artifacts (s(x) table, debiased split) from a run directory."""
    import numpy as np

    from tst_torch.data.schema import BlindDataset
    from tst_torch.io import outputs

    run_dir = args.run_dir
    ds = BlindDataset.load_jsonl(f"{run_dir}/dataset.jsonl")
    _, sx, fold = _read_sx(run_dir)
    out = args.out or run_dir
    if args.prune_fraction:
        order = np.argsort(-np.where(np.isnan(sx), -np.inf, sx), kind="stable")
        n_prune = int(round(args.prune_fraction * len(ds)))
        keep = np.ones(len(ds), bool)
        keep[order[:n_prune]] = False
        outputs.write_debiased_split(out, ds, keep,
                                     audit={"pruned": int(n_prune), "rule": "top-s_x"})
    outputs.write_sx_table(out, ds, sx, fold)
    print(json.dumps({"exported_to": out, "n": len(ds)}))
    return 0


def _load_reference_kept(path: str, bench: Optional[str]) -> List[str]:
    """Sample ids of a reference kept-split file: our own jsonl schema (a
    BlindDataset dump), or with ``bench`` the raw HuggingFace rows of that
    benchmark, parsed by the adapter that parsed the original run."""
    if bench:
        from tst_torch.data.adapters import ADAPTERS

        if bench not in ADAPTERS:
            raise KeyError(f"unknown benchmark {bench!r}; have {sorted(ADAPTERS)}")
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return [s.id for s in ADAPTERS[bench].rows_to_samples(rows)]
    from tst_torch.data.schema import BlindDataset

    return [s.id for s in BlindDataset.load_jsonl(path)]


def cmd_compare(args) -> int:
    """Ranking-parity report: our s(x) vs a reference kept split (and, when
    given, a reference s(x) vector) → ``parity.json``."""
    import numpy as np

    from tst_torch.eval.parity import membership_agreement, spearman
    from tst_torch.io import outputs

    ids, sx, _ = _read_sx(args.run_dir)
    kept_ids = _load_reference_kept(args.reference_kept, args.bench)
    report = membership_agreement(sx, ids, kept_ids)
    if args.reference_sx:
        ref = {}
        with open(args.reference_sx) as f:
            for line in f:
                row = json.loads(line)
                ref[row["id"]] = row["s_x"]
        ref_v = np.asarray([ref.get(i, float("nan")) for i in ids], np.float32)
        report["spearman"] = round(spearman(sx, ref_v), 4)
    report["run_dir"] = args.run_dir
    report["reference_kept"] = args.reference_kept
    outputs.write_report(args.out or args.run_dir, report, name="parity.json")
    print(json.dumps(report, indent=2))
    return 0


def _adapter_flags(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("--adapter", default=None,
                    help="LoRA checkpoint dir to serve, as diagnose-sft writes it under "
                         "checkpoint_dir (default: zero-shot base model)")
    sp.add_argument("--fold", default="0",
                    help="which fold's adapter serves: an index, or 'mean' to average "
                         "adapters across folds")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tst_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("eval-blind")
    _common_flags(sp)
    _adapter_flags(sp)
    sp.add_argument("--full-accuracy", type=float, default=None,
                    help="externally measured WITH-vision accuracy; "
                         "adds the vision_blind_gap to the report")
    sp.set_defaults(fn=cmd_eval_blind)
    for name, fn in (("diagnose-rf", cmd_diagnose_rf), ("diagnose-sft", cmd_diagnose_sft),
                     ("warmup", cmd_warmup), ("debias-ibp", cmd_debias_ibp),
                     ("train-transfer", cmd_train_transfer), ("generate", cmd_generate)):
        sp = sub.add_parser(name)
        _common_flags(sp)
        sp.add_argument("--k", type=int, default=None, help="number of folds (shorthand)")
        if name == "warmup":
            sp.add_argument("--ibp", action="store_true",
                            help="the kernels of a debias-ibp run instead of diagnose-sft's")
        if name == "train-transfer":
            sp.add_argument("--train-bench", required=True,
                            help="training benchmark (e.g. a VSI-Train-10k jsonl)")
            sp.add_argument("--train-source", default=None)
        if name == "generate":
            sp.add_argument("--max-new", type=int, default=16)
            sp.add_argument("--draft-model", default=None,
                            help="draft geometry name for speculative decoding (must share "
                                 "the tokenizer, e.g. llama3.2-1b for llama3-8b)")
            sp.add_argument("--draft-path", default=None,
                            help="local HF checkpoint dir for the draft")
            sp.add_argument("--draft-quantize", default=None,
                            choices=["none", "int8", "int4"],
                            help="draft weight storage (int4 through the K3 kernel)")
            sp.add_argument("--gamma", type=int, default=4,
                            help="draft tokens proposed per verify round")
            _adapter_flags(sp)
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("export")
    sp.add_argument("run_dir")
    sp.add_argument("--out", default=None)
    sp.add_argument("--prune-fraction", type=float, default=None)
    sp.set_defaults(fn=cmd_export)
    sp = sub.add_parser("compare", help="ranking parity vs a reference artifact")
    sp.add_argument("run_dir", help="run dir containing sx.jsonl")
    sp.add_argument("--out", default=None,
                    help="directory for parity.json (default: run_dir)")
    sp.add_argument("--reference-kept", required=True,
                    help="jsonl of the reference's kept (debiased) samples")
    sp.add_argument("--bench", default=None,
                    help="parse --reference-kept as RAW HF rows of this benchmark "
                         "instead of our jsonl schema")
    sp.add_argument("--reference-sx", default=None,
                    help="optional jsonl with a reference s_x column for Spearman")
    sp.set_defaults(fn=cmd_compare)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
