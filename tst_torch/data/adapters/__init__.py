# The port's own copy of tst/data/adapters/__init__.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Benchmark adapters: HF rows → canonical blind :class:`~tst_torch.data.schema.Sample`.

The framework is applied "to four benchmarks—VSI-Bench, CV-Bench, MMMU, and
VideoMME" (reference README.md:35). Each adapter exposes:

  * ``rows_to_samples(rows)``  — pure row conversion (offline-unit-testable)
  * ``load(source, split)``    — HF hub id / local dataset dir / jsonl file

All adapters strip visual payloads and keep only text, per the blind-input
requirement (reference README.md:35).
"""

from tst_torch.data.adapters import cv_bench, mmmu, video_mme, vsi_bench  # noqa: F401

ADAPTERS = {
    "vsi_bench": vsi_bench,
    "cv_bench": cv_bench,
    "mmmu": mmmu,
    "video_mme": video_mme,
}


def load_benchmark(name: str, source=None, split=None, **kw):
    """Uniform entry: ``load_benchmark("cv_bench", "/data/cv_bench")``.

    ``name`` may also be ``synthetic[:spec]`` for offline smoke runs.
    """
    include_open = kw.pop("include_open", None)  # only MMMU has an open split
    if name.startswith("synthetic"):
        from tst_torch.data.synthetic import (make_synthetic_mcq,
                                        make_synthetic_numeric,
                                        make_synthetic_open,
                                        make_synthetic_vsi)

        # "synthetic[:bias_fraction[:bias_kind]]" | "synthetic-open[:bias]"
        # | "synthetic-numeric[:bias]" (VSI-style numeric answers,
        #   decode-scored; bias rows share one constant gold value)
        # | "synthetic-vsi[:bias[:bias_kind]]" (VSI-shaped ~3:1 MCQ+numeric
        #   mix — the north-star wall-clock anchor workload)
        parts = name.split(":")
        bias = float(parts[1]) if len(parts) > 1 else 0.0
        if parts[0] == "synthetic-open":
            return make_synthetic_open(n=kw.pop("n", 128), bias_fraction=bias,
                                       seed=kw.pop("seed", 0))
        if parts[0] == "synthetic-numeric":
            return make_synthetic_numeric(n=kw.pop("n", 128),
                                          bias_fraction=bias,
                                          seed=kw.pop("seed", 0))
        if parts[0] == "synthetic-vsi":
            return make_synthetic_vsi(
                n=kw.pop("n", 5000), bias_fraction=bias,
                bias_kind=parts[2] if len(parts) > 2 else "longest_option",
                seed=kw.pop("seed", 0))
        if len(parts) > 2:
            kw.setdefault("bias_kind", parts[2])
        return make_synthetic_mcq(n=kw.pop("n", 256), bias_fraction=bias, **kw)
    if name.endswith(".jsonl"):
        from tst_torch.data.schema import BlindDataset

        return BlindDataset.load_jsonl(name)
    if name not in ADAPTERS:
        raise KeyError(f"unknown benchmark {name!r}; have {sorted(ADAPTERS)}")
    mod = ADAPTERS[name]
    args = {} if split is None else {"split": split}
    if name == "mmmu" and include_open is not None:
        args["mcq_only"] = not include_open
    return mod.load(source, **args, **kw) if source else mod.load(**args, **kw)
