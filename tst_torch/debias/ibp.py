"""Iterative Bias Pruning, ``debias-ibp`` (counterpart of
``tst/debias/ibp.py``).

  round r: run the k-fold diagnostic on the surviving set → s(x)
           → prune the top ``prune_rate`` fraction by s(x)
             (optionally category-balanced, so no question type is wiped out)
           → stop when every exploitability signal is within
             ``stop_epsilon`` of its chance level, or after R rounds.

The diagnostic is the blind-SFT engine (default) or the RF auditor. The SFT
rounds are ``diagnose-sft`` rounds: tokenized once, the base model built
once, each round training on the surviving rows through fold index
streams, with the attention kernels on the card. The state after each
round is persisted, so a killed run resumes (``ibp.resume``).

Two choices of the reference are not copied: its round-0 shape pins
(``pad_m``, ``pad_numeric``, ``pad_open``, ``pack_rows0``,
``score_rows0``) exist only to stop XLA retracing and change no number,
so eager torch drops them (``total_steps0``, which sets the LR schedule,
stays); and two reference defects are repaired (ROADMAP §3): a NaN
``sx_seed_spearman`` is left out of the report, and a round's stage walls
keep the stages that measured 0.0.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tst_torch.config import RunConfig
from tst_torch.data.folds import kfold_assign
from tst_torch.data.packing import make_packed_fold_batches, pack_fold_datasets
from tst_torch.data.schema import MCQ, NUMERIC, OPEN, BlindDataset
from tst_torch.data.tokenize import tokenize_dataset
from tst_torch.diagnose.rf import run_rf_diagnostic
from tst_torch.diagnose.score import bias_scores
from tst_torch.eval import metrics
from tst_torch.eval.parity import spearman
from tst_torch.io import outputs
from tst_torch.train.infer import (score_heldout_mcq, score_heldout_mcq_packed,
                                   score_heldout_numeric, score_heldout_open)
from tst_torch.train.pipeline import (_check_sft_config, build_model, build_tokenizer,
                                      lora_spec_from_cfg)
from tst_torch.train.sft import FoldTrainer, make_fold_batches


def prune_mask(
    s_x: np.ndarray,
    alive: np.ndarray,
    prune_rate: float,
    categories: Optional[np.ndarray] = None,
    min_keep: int = 8,
) -> np.ndarray:
    """One pruning step: drop the top ``prune_rate`` fraction of *alive*
    samples by s(x). NaN s(x) (non-MCQ rows) are never pruned.

    ``categories`` (int ids) switches to category-balanced pruning: the
    per-round prune budget is split across categories proportionally to their
    surviving counts, so pruning cannot collapse a whole question type.
    """
    alive = np.asarray(alive, bool).copy()
    s = np.where(np.isnan(s_x), -np.inf, np.asarray(s_x, np.float32))
    n_alive = int(alive.sum())
    budget = int(round(prune_rate * n_alive))
    if budget <= 0 or n_alive <= min_keep:
        return alive
    budget = min(budget, n_alive - min_keep)

    def prune_from(rows: np.ndarray, quota: int) -> List[int]:
        order = rows[np.argsort(-s[rows], kind="stable")]
        order = order[np.isfinite(s[order])]
        return list(order[:quota])

    to_prune: List[int] = []
    if categories is None:
        to_prune = prune_from(np.flatnonzero(alive), budget)
    else:
        categories = np.asarray(categories)
        cats, counts = np.unique(categories[alive], return_counts=True)
        # largest-remainder apportionment of the budget over categories
        raw = budget * counts / counts.sum()
        quotas = np.floor(raw).astype(int)
        rem = budget - quotas.sum()
        for i in np.argsort(-(raw - quotas), kind="stable")[:rem]:
            quotas[i] += 1
        for c, quota in zip(cats, quotas):
            rows = np.flatnonzero(alive & (categories == c))
            to_prune += prune_from(rows, int(quota))
    alive[np.asarray(to_prune, int)] = False
    return alive


def run_ibp(ds: BlindDataset, cfg: RunConfig, device: torch.device) -> Dict[str, Any]:
    """Full IBP pipeline → debiased split + audit trail + report; the
    diagnostic's device work on ``device``."""
    t_start = time.time()
    n = len(ds)
    alive = np.ones(n, bool)
    cat_names = ds.categories
    cat_ids = np.array([cat_names.index(s.category) for s in ds])
    audit: List[Dict[str, Any]] = []
    last_sx = np.full(n, np.nan, np.float32)
    last_fold = np.full(n, -1, np.int32)
    last_scored = np.zeros(0, np.int64)  # rows scored in the FINAL round

    use_sft = cfg.ibp.diagnostic == "sft"
    if not use_sft and cfg.ibp.diagnostic != "rf":
        raise ValueError(f"unknown ibp.diagnostic {cfg.ibp.diagnostic!r}")
    sft = _SftRoundRunner(ds, cfg, device) if use_sft else None
    rounds_run = 0
    stop_reason = "max_rounds"
    start_round = 0
    state = _load_ibp_state(ds, cfg)
    if state is not None:
        start_round = int(state["next_round"])
        alive = np.asarray(state["alive"], bool)
        audit = list(state["audit"])
        last_sx = np.asarray(
            [np.nan if v is None else v for v in state["last_sx"]], np.float32)
        last_fold = np.asarray(state["last_fold"], np.int32)
        last_scored = np.asarray(state["last_scored"], np.int64)
        rounds_run = start_round
    for r in range(start_round, cfg.ibp.rounds):
        t_round = time.time()
        sub_idx = np.flatnonzero(alive)
        sub = ds.subset(sub_idx)
        if use_sft:
            s_sub, fold_sub, stats = sft.run_round(r, alive)
            last_fold[sub_idx] = fold_sub
        else:
            d = run_rf_diagnostic(sub, k=cfg.data.k, seed=cfg.data.seed + r,
                                  n_estimators=cfg.rf.n_estimators,
                                  max_depth=cfg.rf.max_depth, backend=cfg.rf.backend,
                                  score_rule=cfg.rf.score_rule, device=device)
            s_sub = d.s_x
            last_fold[sub_idx] = d.fold_id
            stats = {"blind_accuracy": d.blind_accuracy, "chance": d.chance,
                     "has_mcq": True}
        blind_acc, chance = stats["blind_accuracy"], stats["chance"]
        last_sx[sub_idx] = s_sub
        last_scored = sub_idx
        rounds_run = r + 1
        row: Dict[str, Any] = {
            "round": r,
            "n_alive": int(alive.sum()),
            "blind_accuracy": float(blind_acc),
            "chance": float(chance),
        }
        for key in ("numeric_mra", "numeric_chance_mra",
                    "open_accuracy", "open_chance_accuracy"):
            if key in stats:
                row[key] = round(float(stats[key]), 4)
        row["round_wall_s"] = round(time.time() - t_round, 2)
        for k2, v in (stats.get("walls") or {}).items():
            row[f"round_{k2}"] = v
        audit.append(row)
        # per-answer-type stop rule: every exploitability signal present on
        # the surviving set must be within eps of its chance level (MCQ:
        # 1/n_options; numeric: uniform-over-range MRA; open: uniform over
        # distinct answers)
        eps = cfg.ibp.stop_epsilon
        signals = []
        if stats.get("has_mcq", True):
            signals.append(("blind_acc<=chance+eps", blind_acc <= chance + eps))
        if "numeric_mra" in stats:
            signals.append(("numeric_mra<=chance+eps",
                            stats["numeric_mra"] <= stats["numeric_chance_mra"] + eps))
        if "open_accuracy" in stats:
            signals.append(("open_acc<=chance+eps",
                            stats["open_accuracy"] <= stats["open_chance_accuracy"] + eps))
        if signals and all(done for _, done in signals):
            stop_reason = (signals[0][0] if len(signals) == 1
                           else "all_signals<=chance+eps")
            break
        new_alive = prune_mask(
            _scatter(s_sub, sub_idx, n), alive, cfg.ibp.prune_rate,
            categories=cat_ids if cfg.ibp.category_balanced else None,
        )
        audit[-1]["pruned_this_round"] = int(alive.sum() - new_alive.sum())
        if new_alive.sum() == alive.sum():
            stop_reason = "no_prunable_samples"
            break
        alive = new_alive
        _save_ibp_state(ds, cfg, next_round=r + 1, alive=alive, audit=audit,
                        last_sx=last_sx, last_fold=last_fold, last_scored=last_scored)
        if cfg.ibp.fail_after_rounds and rounds_run >= cfg.ibp.fail_after_rounds:
            raise RuntimeError(
                f"ibp.fail_after_rounds={cfg.ibp.fail_after_rounds}: "
                f"injected failure after round {r} (state persisted)")

    report: Dict[str, Any] = {
        "benchmark": ds.name,
        "rounds_run": rounds_run,
        "stop_reason": stop_reason,
        "n_original": n,
        "n_debiased": int(alive.sum()),
        "fraction_kept": float(alive.sum() / n),
        "final_blind_accuracy": audit[-1]["blind_accuracy"] if audit else None,
        "final_chance": audit[-1]["chance"] if audit else None,
        "per_round": audit,
        "resumed_from_round": start_round if start_round else None,
        "wall_seconds": round(time.time() - t_start, 2),
    }
    # seed-stability of s(x), only when finite (a NaN would make the report
    # non-strict JSON); and RF-vs-SFT rank agreement on the last scored set
    # (the host-side backend)
    if use_sft and sft.last_seed_spearman is not None and np.isfinite(sft.last_seed_spearman):
        report["sx_seed_spearman"] = round(float(sft.last_seed_spearman), 4)
    # only the FINAL round's rows: earlier-pruned rows carry s(x) from models
    # trained on other survivor sets
    scored = last_scored
    if use_sft and cfg.rf.cross_check and scored.size:
        sub = ds.subset(scored)
        if any(s.answer_type == MCQ for s in sub):
            # an optional statistic never takes the run's artifacts down: heavy
            # pruning can leave too few MCQ rows per fold
            try:
                rf_d = run_rf_diagnostic(
                    sub, k=cfg.data.k, seed=cfg.data.seed,
                    n_estimators=cfg.rf.n_estimators, max_depth=cfg.rf.max_depth,
                    backend="sklearn", score_rule=cfg.rf.score_rule, device=device)
                report["rf_sft_spearman"] = round(float(spearman(rf_d.s_x, last_sx[scored])), 4)
                report["rf_blind_accuracy"] = round(float(rf_d.blind_accuracy), 4)
            except ValueError as e:
                report["rf_cross_check_skipped"] = str(e)
    outputs.write_debiased_split(cfg.out_dir, ds, alive,
                                 audit={"rounds": audit, "config": cfg.to_json()})
    outputs.write_sx_table(cfg.out_dir, ds, last_sx, fold_id=last_fold,
                           extra={"kept": alive.astype(np.float32)})
    outputs.write_report(cfg.out_dir, report, name="ibp_report.json")
    _clear_ibp_state(cfg)  # run completed: the resume point is obsolete
    return report


def _ibp_state_path(cfg: RunConfig) -> str:
    return os.path.join(cfg.out_dir, "ibp_state.json")


def _ibp_config_hash(ds: BlindDataset, cfg: RunConfig) -> str:
    """Fingerprint of everything that determines the loop's trajectory — a
    resumed state from another dataset or config must not be reused."""
    blob = cfg.to_json()
    blob["ibp"] = {k: v for k, v in blob["ibp"].items()
                   if k not in ("resume", "fail_after_rounds")}
    blob.pop("out_dir", None)
    blob.pop("profile_dir", None)
    blob.pop("log_every", None)
    blob.pop("perf", None)  # kernel tuning changes speed, not trajectory
    key = json.dumps({"cfg": blob, "bench": ds.name, "n": len(ds)}, sort_keys=True)
    return hashlib.sha1(key.encode()).hexdigest()[:12]


def _save_ibp_state(ds, cfg, *, next_round, alive, audit, last_sx, last_fold,
                    last_scored) -> None:
    """Persist the loop's resume point after a completed round; an atomic
    rename, so a crash mid-write leaves the previous round's state."""
    os.makedirs(cfg.out_dir, exist_ok=True)
    path = _ibp_state_path(cfg)
    state = {
        "config_hash": _ibp_config_hash(ds, cfg),
        "next_round": int(next_round),
        "alive": np.asarray(alive, bool).tolist(),
        "audit": audit,
        "last_sx": [None if not np.isfinite(v) else float(v) for v in last_sx],
        "last_fold": np.asarray(last_fold, np.int32).tolist(),
        "last_scored": np.asarray(last_scored, np.int64).tolist(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def _load_ibp_state(ds, cfg) -> Optional[Dict[str, Any]]:
    """The resumable state if ``ibp.resume`` is on, the file exists and its
    config hash matches; otherwise None (a fresh start)."""
    path = _ibp_state_path(cfg)
    if not cfg.ibp.resume or not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    if state.get("config_hash") != _ibp_config_hash(ds, cfg):
        return None  # another dataset or config wrote this out_dir
    if len(state.get("alive", [])) != len(ds):
        return None
    return state


def _clear_ibp_state(cfg: RunConfig) -> None:
    path = _ibp_state_path(cfg)
    if os.path.exists(path):
        os.remove(path)


def _scatter(values: np.ndarray, idx: np.ndarray, n: int) -> np.ndarray:
    out = np.full(n, np.nan, np.float32)
    out[idx] = values
    return out


def _numeric_chance_mra(gold_values: np.ndarray) -> float:
    """Chance MRA for the surviving numeric rows: the expected MRA of a
    uniform draw over the golds' value range. Analytic: for gold g and
    threshold θ, P(|u-g|/|g| < 1-θ) = |[gθ, g(2-θ)] ∩ [lo, hi]| / (hi-lo)."""
    g = np.abs(gold_values[np.isfinite(gold_values)].astype(np.float64))
    if g.size == 0:
        return 0.0
    lo, hi = float(g.min()), float(g.max())
    if hi - lo < 1e-12:  # degenerate range: a uniform "draw" always hits
        return 1.0
    probs = []
    for th in metrics.MRA_THRESHOLDS:
        a = np.maximum(g * th, lo)
        b = np.minimum(g * (2.0 - th), hi)
        probs.append(np.maximum(b - a, 0.0) / (hi - lo))
    return float(np.mean(probs))


def _open_chance_acc(gold_texts: List[Optional[str]]) -> float:
    """Chance exact match for the surviving open rows: a uniform guess over
    the distinct normalized surviving answers."""
    answers = [metrics.normalize_open_answer(g) for g in gold_texts if g is not None]
    if not answers:
        return 0.0
    return 1.0 / max(len(set(answers)), 1)


def _nanmean_rows(rows: List[np.ndarray]) -> np.ndarray:
    """nanmean over seed restarts without the all-NaN-column warning."""
    stacked = np.stack(rows).astype(np.float32)
    finite = np.isfinite(stacked)
    count = finite.sum(axis=0)
    total = np.where(finite, stacked, 0.0).sum(axis=0)
    return np.where(count > 0, total / np.maximum(count, 1), np.nan)


def round0_sizing(ds, cfg, k: int) -> Dict[str, Optional[int]]:
    """Round-0 sizing of the IBP loop (the reference's one definition).

    - ``total_steps0`` is an upper bound on the largest train split across
      rounds: the smallest stratified fold holds >= n//k - n_strata rows, so
      train <= n - n//k + n_strata. It sets the LR schedule of every round.
    - ``pad_m``, ``pad_numeric`` and ``pad_open`` bound a round's per-fold
      held-out counts (the reference pins its scorer and decode grids to
      them; the port does not need them).
    """
    n = len(ds)
    b = cfg.optim.batch_size + (-cfg.optim.batch_size) % max(cfg.mesh.data, 1)
    n_strata = len({(s.category, s.answer_type, s.answer) for s in ds})
    max_train = n - max(n // k - n_strata, 0)

    def _pad_for(rows_pred):
        rows = [s for s in ds if rows_pred(s)]
        if not rows:
            return None
        strata = len({(s.category, s.answer_type, s.answer) for s in rows})
        return min(len(rows), int(np.ceil(len(rows) / k)) + strata)

    return {
        "total_steps0": int(np.ceil(max_train / b)) * cfg.optim.epochs,
        "pad_m": min(n, int(np.ceil(n / k)) + n_strata),
        "pad_numeric": _pad_for(lambda s: s.answer_type == NUMERIC),
        "pad_open": _pad_for(lambda s: s.answer_type == OPEN),
    }


class _SftRoundRunner:
    """IBP rounds with the blind-SFT diagnostic: tokenize once, build the
    base model once, and give every round's trainer the same LR schedule
    (``total_steps0``). Rounds differ only in host-side index streams and
    survivor masks."""

    def __init__(self, ds: BlindDataset, cfg: RunConfig, device: torch.device):
        _check_sft_config(ds, cfg)
        self.ds = ds
        self.cfg = cfg
        self.k = cfg.data.k
        self.device = device
        self.tokenizer = build_tokenizer(cfg)
        self.tb = tokenize_dataset(ds, self.tokenizer, max_len=cfg.data.max_len,
                                   include_context=cfg.data.include_context)
        self.spec, self.params = build_model(cfg, self.tokenizer, device)
        self.lspec = lora_spec_from_cfg(cfg, self.spec.dtype)
        #: mid-training epochs whose held-out probs average into s(x)
        self.score_after = {int(e) for e in cfg.optim.score_epochs
                            if 1 <= int(e) < cfg.optim.epochs}
        self.tokens, self.loss_mask, self.answer_pos = (
            torch.from_numpy(a).to(device)
            for a in (self.tb.tokens, self.tb.loss_mask, self.tb.answer_pos))
        self.t_max = int(np.max(self.tb.lengths - self.tb.answer_pos - 1))
        self.total_steps0 = round0_sizing(ds, cfg, self.k)["total_steps0"]
        #: sequence packing (optim.pack): each round packs its surviving set
        self.pack_len = (int(cfg.optim.pack_len) or 2 * self.tb.seq_len) if cfg.optim.pack else 0
        single_tok = (self.tb.option_token_seqs is None
                      or self.tb.option_token_seqs.shape[-1] == 1)
        self.use_packed_scorer = bool(self.pack_len and cfg.optim.packed_scorer and single_tok)
        #: pairwise Spearman of per-seed final s(x) in the latest round (None
        #: unless optim.n_seeds > 1)
        self.last_seed_spearman: Optional[float] = None
        self.use_pallas = cfg.model.use_pallas
        self.trainer = FoldTrainer(
            self.spec, self.lspec, self.k, lr=cfg.optim.lr,
            total_steps=self.total_steps0,  # the same schedule every round
            warmup_frac=cfg.optim.warmup_frac, weight_decay=cfg.optim.weight_decay,
            use_pallas=self.use_pallas, t_max=self.t_max, b1=cfg.optim.b1, b2=cfg.optim.b2,
            fused_mlp=cfg.model.fused_mlp, packed=bool(self.pack_len))

    def _batches(self, fold_global, alive, pack, seed):
        cfg = self.cfg
        if pack is not None:
            return make_packed_fold_batches(pack.n_rows, cfg.optim.batch_size, cfg.optim.epochs,
                                            seed, batch_multiple=cfg.mesh.data)
        return make_fold_batches(fold_global, self.k, cfg.optim.batch_size, cfg.optim.epochs,
                                 seed, batch_multiple=cfg.mesh.data, include_mask=alive)

    def run_round(self, r: int, alive: np.ndarray):
        """→ (s(x) over the surviving rows, their fold ids, stats)."""
        cfg = self.cfg
        #: this round's stage walls (round_*_s in the audit rows)
        walls = {"setup_s": 0.0, "train_s": 0.0, "mcq_score_s": 0.0,
                 "numeric_decode_s": 0.0, "open_decode_s": 0.0}
        t_setup = time.time()
        sub_idx = np.flatnonzero(alive)
        sub = self.ds.subset(sub_idx)
        fold_sub = kfold_assign(sub, self.k, cfg.data.seed + 1000 * r)
        fold_global = np.full(len(self.ds), -1, np.int32)
        fold_global[sub_idx] = fold_sub

        pack = None
        train_data = dict(all_tokens=self.tokens, all_mask=self.loss_mask,
                          all_pos=self.answer_pos)
        if self.pack_len:
            pack = pack_fold_datasets(self.tb, fold_global, self.k, self.pack_len,
                                      include_mask=alive)
            ptok, pmask, ppos, psegs = (
                torch.from_numpy(a).to(self.device)
                for a in (pack.tokens, pack.loss_mask, pack.answer_pos, pack.seg_starts))
            train_data = dict(all_tokens=ptok, all_mask=pmask, all_pos=ppos, all_segs=psegs,
                              n_segs=pack.n_segs)
        batches = self._batches(fold_global, alive, pack, cfg.data.seed + r)
        walls["setup_s"] = time.time() - t_setup
        n_seeds = max(int(cfg.optim.n_seeds), 1)
        seed_probs, seed_final, seed_s_num, seed_s_open = [], [], [], []
        gold_values = np.array(
            [s.answer_value if s.answer_type == NUMERIC else np.nan for s in self.ds],
            np.float32)
        has_numeric = bool(np.isfinite(gold_values[sub_idx]).any())
        gold_texts = [s.answer if (s.answer_type == OPEN and alive[i]) else None
                      for i, s in enumerate(self.ds)]
        has_open = any(g is not None for g in gold_texts)
        # numeric and open rows are decode-scored, so the MCQ grid holds the
        # MCQ rows only
        mcq_fold = np.where(self.tb.gold >= 0, fold_global, -1)

        def mcq_score(lora_now):
            if not (self.tb.gold >= 0).any():
                # all-numeric/open dataset: no letter columns to read
                return np.zeros((len(self.ds), 1), np.float32)
            if self.use_packed_scorer:
                return score_heldout_mcq_packed(
                    self.params, lora_now, self.spec, self.lspec, self.tb, mcq_fold, self.k,
                    pack_len=self.pack_len, use_pallas=self.use_pallas)
            return score_heldout_mcq(
                self.params, lora_now, self.spec, self.lspec, self.tokens, self.answer_pos,
                self.tb.option_token_ids, self.tb.n_options, mcq_fold, self.k,
                use_pallas=self.use_pallas, option_seqs=self.tb.option_token_seqs)

        def timed(key, thunk):
            t = time.time()
            out = thunk()
            walls[key] += time.time() - t
            return out

        steps_per_epoch = max(batches.shape[0] // max(cfg.optim.epochs, 1), 1)
        for s_i in range(n_seeds):
            lora, opt = self.trainer.init_state(torch.Generator(device=self.device).manual_seed(
                cfg.data.seed + 1 + r + 7919 * s_i))
            if s_i > 0:
                batches = self._batches(fold_global, alive, pack, cfg.data.seed + r + 31 * s_i)
            # epoch-chunked training, so mid-training snapshots can be scored
            for e in range(cfg.optim.epochs):
                chunk = batches[e * steps_per_epoch: (e + 1) * steps_per_epoch]
                if e == cfg.optim.epochs - 1:  # the last epoch takes any remainder
                    chunk = batches[e * steps_per_epoch:]
                if chunk.shape[0] == 0:
                    continue
                lora, opt, _ = timed("train_s", lambda: self.trainer.fit(
                    self.params, lora, opt, batches=chunk, log_every=cfg.log_every,
                    **train_data))
                if (e + 1) in self.score_after:
                    seed_probs.append(timed("mcq_score_s", lambda: mcq_score(lora)))
            final_p = timed("mcq_score_s", lambda: mcq_score(lora))
            seed_probs.append(final_p)
            seed_final.append(final_p)
            if has_numeric:
                _, s_num_i = timed("numeric_decode_s", lambda: score_heldout_numeric(
                    self.params, lora, self.spec, self.lspec, self.tokens, self.answer_pos,
                    np.where(alive, gold_values, np.nan), fold_global, self.k,
                    tokenizer=self.tokenizer, use_pallas=self.use_pallas))
                seed_s_num.append(s_num_i)
            if has_open:
                _, s_open_i = timed("open_decode_s", lambda: score_heldout_open(
                    self.params, lora, self.spec, self.lspec, self.tokens, self.answer_pos,
                    gold_texts, fold_global, self.k, tokenizer=self.tokenizer,
                    use_pallas=self.use_pallas))
                seed_s_open.append(s_open_i)
        probs = np.mean(seed_probs, axis=0) if len(seed_probs) > 1 else seed_probs[0]
        probs_sub = probs[sub_idx]
        gold_sub = self.tb.gold[sub_idx]
        nopt_sub = self.tb.n_options[sub_idx]
        s_sub = bias_scores(probs_sub, gold_sub, nopt_sub, rule=cfg.rf.score_rule)
        self.last_seed_spearman = None
        if len(seed_final) > 1:
            per_seed = [bias_scores(p[sub_idx], gold_sub, nopt_sub, rule=cfg.rf.score_rule)
                        for p in seed_final]
            rhos = [spearman(per_seed[i], per_seed[j])
                    for i in range(len(per_seed)) for j in range(i + 1, len(per_seed))]
            self.last_seed_spearman = float(np.nanmean(rhos))
        pred = probs_sub.argmax(-1)
        stats: Dict[str, Any] = {
            "blind_accuracy": float(metrics.accuracy(pred, gold_sub)),
            "chance": float(metrics.chance_accuracy(nopt_sub)),
            "has_mcq": bool((gold_sub >= 0).any()),
            "walls": {k2: round(v, 2) for k2, v in walls.items()},
        }
        # numeric and open rows: held-out greedy decode, their s(x) averaged
        # over the same seed restarts as the MCQ scores
        if seed_s_num:
            s_num = _nanmean_rows(seed_s_num)
            s_sub = np.where(np.isfinite(s_num[sub_idx]), s_num[sub_idx], s_sub)
            finite = np.isfinite(s_num[sub_idx])
            if finite.any():
                stats["numeric_mra"] = float(np.mean(s_num[sub_idx][finite]))
                stats["numeric_chance_mra"] = _numeric_chance_mra(
                    np.where(alive, gold_values, np.nan))
        if seed_s_open:
            s_open = _nanmean_rows(seed_s_open)
            s_sub = np.where(np.isfinite(s_open[sub_idx]), s_open[sub_idx], s_sub)
            finite = np.isfinite(s_open[sub_idx])
            if finite.any():
                stats["open_accuracy"] = float(np.mean(s_open[sub_idx][finite]))
                stats["open_chance_accuracy"] = _open_chance_acc(gold_texts)
        return s_sub, fold_sub, stats
