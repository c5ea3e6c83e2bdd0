"""``tst_torch`` command-line interface (counterpart of ``tst/cli.py``).

Ported subcommands:

  * ``eval-blind``   — zero-shot blind evaluation (vision-blind-gap leg)
  * ``diagnose-sft`` — k-fold blind LoRA SFT diagnostic (the core method)

They take the flags of their ``tst`` counterparts and read the same
``RunConfig`` and presets; ``--platform`` is ``gpu`` (the default: the CUDA
device, and an error without one) or ``cpu``. ``--set perf.*`` has no
effect here: those are TPU kernel knobs. Every other subcommand of ``tst``
exits non-zero with the ROADMAP item that ports it.

Run as ``python -m tst_torch <subcommand> ...``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from tst_torch import config as config_mod
from tst_torch.config import RunConfig
from tst_torch.runtime.device import PLATFORMS, select_device

#: subcommands of ``tst`` that the port does not have yet → ROADMAP item
NOT_PORTED = {
    "diagnose-rf": 10,
    "warmup": 15,
    "debias-ibp": 12,
    "train-transfer": 15,
    "generate": 15,
    "export": 15,
    "compare": 15,
}


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


def _resolve(args):
    """(RunConfig, torch.device) from the parsed flags."""
    device = select_device(args.platform)
    cfg = config_mod.resolve(args.preset, args.config, args.overrides)
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
    report = run_blind_eval(ds, cfg, device, adapter_dir=args.adapter,
                            full_accuracy=args.full_accuracy)
    print(json.dumps(report, indent=2, default=float))
    return 0


def cmd_diagnose_sft(args) -> int:
    from tst_torch.train.pipeline import run_sft_diagnostic

    if args.profile_dir or args.debug_nans:
        raise NotImplementedError("--profile-dir and --debug-nans are not ported to "
                                  "tst_torch yet (ROADMAP item 17)")
    cfg, device = _resolve(args)
    if args.k is not None:
        cfg.data.k = args.k
    ds = _load_dataset(cfg)
    report = run_sft_diagnostic(ds, cfg, device)
    print(json.dumps(report, indent=2, default=float))
    return 0


def _cmd_not_ported(args) -> int:
    print(f"tst_torch {args.cmd}: not yet ported (ROADMAP item {NOT_PORTED[args.cmd]})",
          file=sys.stderr)
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tst_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("eval-blind")
    _common_flags(sp)
    sp.add_argument("--adapter", default=None,
                    help="LoRA checkpoint dir to serve (not ported yet: ROADMAP item 5)")
    sp.add_argument("--full-accuracy", type=float, default=None,
                    help="externally measured WITH-vision accuracy; "
                         "adds the vision_blind_gap to the report")
    sp.set_defaults(fn=cmd_eval_blind)
    sp = sub.add_parser("diagnose-sft")
    _common_flags(sp)
    sp.add_argument("--k", type=int, default=None, help="number of folds (shorthand)")
    sp.add_argument("--profile-dir", default=None, help="not ported yet (ROADMAP item 17)")
    sp.add_argument("--debug-nans", action="store_true",
                    help="not ported yet (ROADMAP item 17)")
    sp.set_defaults(fn=cmd_diagnose_sft)
    for name in NOT_PORTED:
        sp = sub.add_parser(name, help=f"not yet ported (ROADMAP item {NOT_PORTED[name]})")
        sp.set_defaults(fn=_cmd_not_ported)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    # a subcommand that is not ported takes any arguments and reports itself
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not _cmd_not_ported:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
