"""Run pipelines of the port (counterpart of ``tst/train/pipeline.py``).

Ported so far:

  * the zero-shot blind evaluation (``eval-blind``): load → blind-render →
    tokenize → model → single-forward MCQ scoring, greedy-decoded numeric
    (MRA) and open (exact match) rows → metrics → ``blind_eval.json``;
  * the core diagnostic (``diagnose-sft``), unpacked or packed
    (``optim.pack``): tokenize → stratified k folds → fold-parallel LoRA SFT
    → held-out scoring with each fold's adapter (MCQ rows by one forward,
    numeric and open rows by greedy decode) → s(x) → metrics →
    ``report.json``, ``sx.jsonl``, ``dataset.jsonl``, ``config.json``,
    ``events.jsonl``.

Both take a quantized base (``model.quantize`` int8 / int4, decoded through
the int4 kernel K3) and ``model.fused_mlp`` (the fused SwiGLU kernel K4 in
training).

What the port does not have yet raises NotImplementedError naming its
ROADMAP item; nothing is silently skipped.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tst_torch.aux.log import JsonlLogger
from tst_torch.config import RunConfig
from tst_torch.data.folds import kfold_assign
from tst_torch.data.schema import NUMERIC, OPEN, BlindDataset
from tst_torch.data.tokenize import ByteTokenizer, HFTokenizer, tokenize_dataset
from tst_torch.data.packing import FoldPacked, make_packed_fold_batches, pack_fold_datasets
from tst_torch.diagnose.rf import run_rf_diagnostic
from tst_torch.diagnose.score import bias_scores
from tst_torch.eval import metrics
from tst_torch.eval.parity import spearman
from tst_torch.io import outputs
from tst_torch.models.decoder import Params, init_params
from tst_torch.models.lora import LoraSpec
from tst_torch.models.quant import quantize_params
from tst_torch.models.spec import ModelSpec, spec_by_name
from tst_torch.train.infer import (score_all_mcq, score_heldout_mcq, score_heldout_mcq_packed,
                                   score_heldout_numeric, score_heldout_open)
from tst_torch.train.sft import FoldTrainer, TrainLog, make_fold_batches

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported to tst_torch yet (ROADMAP item {item})")


def build_tokenizer(cfg: RunConfig):
    t = cfg.model.tokenizer
    style = cfg.data.prompt_style
    if style not in ("completion", "chat"):
        raise ValueError(f"unknown data.prompt_style {style!r}")
    chat = style == "chat"
    if t == "byte":
        if chat:
            raise ValueError("data.prompt_style='chat' needs an HF tokenizer "
                             "with a chat template (byte tokenizer has none)")
        return ByteTokenizer()
    if t == "hf":
        path = cfg.model.path
        if path is None:
            raise ValueError("model.tokenizer='hf' needs model.path (local checkpoint dir)")
        return HFTokenizer(path, chat=chat)
    return HFTokenizer(t, chat=chat)  # explicit tokenizer path


def build_model(cfg: RunConfig, tokenizer,
                device: torch.device) -> Tuple[ModelSpec, Params]:
    """ModelSpec + random-init params on ``device``, from a generator seeded
    with ``data.seed``; ``model.quantize`` int8 / int4 quantizes the big
    matrices after the init, leaf by leaf (tst_torch.models.quant)."""
    dtype = DTYPES[cfg.model.dtype]
    quant_bits = {"none": None, "int8": 8, "int4": 4}.get(cfg.model.quantize, -1)
    if quant_bits == -1:
        raise ValueError(f"unknown model.quantize {cfg.model.quantize!r}")
    if cfg.model.path:
        _not_ported("loading a checkpoint (model.path)", 3)
    spec = spec_by_name(cfg.model.name, dtype=dtype)
    if spec.vocab_size < tokenizer.vocab_size:
        spec = spec_by_name(cfg.model.name, dtype=dtype, vocab_size=tokenizer.vocab_size)
    rng = torch.Generator(device=device).manual_seed(cfg.data.seed)
    params = init_params(rng, spec)
    if quant_bits is not None:
        params = quantize_params(params, bits=quant_bits)
    return spec, params


def _check_spec_decode(cfg: RunConfig) -> None:
    if cfg.perf.spec_draft_model or cfg.perf.spec_draft_path:
        _not_ported("speculative decode (perf.spec_draft_model / perf.spec_draft_path)", 15)


def gold_values_of(ds: BlindDataset) -> np.ndarray:
    """[N] numeric gold answers, NaN on other rows."""
    return np.asarray([s.answer_value if s.answer_type == NUMERIC else np.nan for s in ds],
                      np.float64)


def gold_texts_of(ds: BlindDataset) -> list:
    """[N] open gold answers, None on other rows."""
    return [s.answer if s.answer_type == OPEN else None for s in ds]


def prepare_blind_eval(ds: BlindDataset, cfg: RunConfig, device: torch.device):
    """(TokenBatch, tokens, answer_pos, spec, params): the tokenized set with
    its tokens and answer positions on ``device``, and the model."""
    tokenizer = build_tokenizer(cfg)
    tb = tokenize_dataset(ds, tokenizer, max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    spec, params = build_model(cfg, tokenizer, device)
    return (tb, torch.from_numpy(tb.tokens).to(device),
            torch.from_numpy(tb.answer_pos).to(device), spec, params)


def run_blind_eval(ds: BlindDataset, cfg: RunConfig, device: torch.device,
                   adapter_dir: Optional[str] = None,
                   full_accuracy: Optional[float] = None) -> Dict[str, Any]:
    """Blind scoring of every sample with the base model, the zero-shot
    baseline leg of the vision-blind gap. ``full_accuracy`` (the with-vision
    accuracy, measured elsewhere) adds ``vision_blind_gap`` to the report.
    Attention goes through the flash kernel when ``model.use_pallas`` is on
    (its plain version for CPU tensors) and the dense path otherwise; numeric
    and open rows are greedy-decoded (int4 weights through K3)."""
    t_start = time.time()
    if adapter_dir:
        _not_ported("serving a LoRA checkpoint (--adapter)", 5)
    if cfg.mesh.fold * cfg.mesh.data * cfg.mesh.seq * cfg.mesh.tensor > 1:
        _not_ported("mesh sizes above 1", 16)
    _check_spec_decode(cfg)
    tb, tokens, answer_pos, spec, params = prepare_blind_eval(ds, cfg, device)
    use_pallas = cfg.model.use_pallas
    # the MCQ leg only when the set has options (an all-numeric or all-open
    # set has none)
    if int(np.max(tb.n_options, initial=0)) > 0:
        probs = score_all_mcq(
            params, spec, tokens, answer_pos, tb.option_token_ids, tb.n_options,
            use_pallas=use_pallas, option_seqs=tb.option_token_seqs,
        )
        pred = probs.argmax(-1).astype(np.int32)
        blind_acc = float(metrics.accuracy(pred, tb.gold))
        chance = float(metrics.chance_accuracy(tb.n_options))
    else:
        blind_acc, chance = 0.0, 0.0
    report = metrics.blind_report(blind_acc, chance, full_acc=full_accuracy,
                                  name=ds.name)
    report["n_mcq"] = int((np.asarray(tb.n_options) > 0).sum())
    tokenizer = build_tokenizer(cfg)
    zero_folds = np.zeros(tb.n, np.int32)
    gold_texts = gold_texts_of(ds)
    if any(g is not None for g in gold_texts):
        _, s_open = score_heldout_open(params, None, spec, None, tokens, answer_pos, gold_texts,
                                       zero_folds, 1, tokenizer=tokenizer, use_pallas=use_pallas)
        report["open_blind_accuracy"] = round(float(np.nanmean(s_open)), 4)
        report["n_open"] = int(sum(g is not None for g in gold_texts))
    # numeric (NA) rows: greedy decode → MRA, the VSI-Bench numeric metric
    gold_values = gold_values_of(ds)
    if np.isfinite(gold_values).any():
        pred_values, _ = score_heldout_numeric(params, None, spec, None, tokens, answer_pos,
                                               gold_values, zero_folds, 1, tokenizer=tokenizer,
                                               use_pallas=use_pallas)
        report["numeric_blind_mra"] = round(
            float(metrics.mra(np.nan_to_num(pred_values), gold_values)), 4)
        report["n_numeric"] = int(np.isfinite(gold_values).sum())
    report.update(n_samples=len(ds), model=spec.name, zero_shot=True,
                  adapter=None, adapter_fold=None,
                  wall_seconds=round(time.time() - t_start, 2))
    outputs.write_report(cfg.out_dir, report, name="blind_eval.json")
    return report


def lora_spec_from_cfg(cfg: RunConfig, dtype: torch.dtype) -> LoraSpec:
    """The LoraSpec of the run (the reference's validation)."""
    if not 0.0 <= float(cfg.lora.dropout) < 1.0:
        raise ValueError(f"lora.dropout must be in [0, 1), got {cfg.lora.dropout}")
    return LoraSpec(rank=cfg.lora.rank, alpha=cfg.lora.alpha,
                    targets=tuple(cfg.lora.targets), dtype=dtype,
                    dropout=float(cfg.lora.dropout))


def _merge_logs(a: Optional[TrainLog], b: TrainLog) -> TrainLog:
    """Concatenate per-epoch TrainLogs into one run-level log."""
    if a is None:
        return b
    a.losses += b.losses
    a.fold_losses += b.fold_losses
    a.steps += b.steps
    a.first_step_seconds += b.first_step_seconds
    a.wall_seconds += b.wall_seconds
    total_samples = (a.samples_per_sec * (a.wall_seconds - b.wall_seconds)
                     + b.samples_per_sec * b.wall_seconds)
    a.samples_per_sec = total_samples / max(a.wall_seconds, 1e-9)
    return a


def _check_sft_config(ds: BlindDataset, cfg: RunConfig) -> None:
    """Raise, before any work, on what the port's diagnose-sft does not have."""
    if cfg.mesh.fold * cfg.mesh.data * cfg.mesh.seq * cfg.mesh.tensor > 1:
        _not_ported("mesh sizes above 1", 16)
    if cfg.model.remat:
        _not_ported("remat (model.remat)", 7)
    if cfg.checkpoint_dir:
        _not_ported("training checkpoints (checkpoint_dir)", 7)
    if cfg.profile_dir:
        _not_ported("profiling (profile_dir)", 17)
    _check_spec_decode(cfg)


class _SftRunState:
    """Everything a diagnose-sft run constructs before its first step."""

    __slots__ = ("tokenizer", "tb", "fold_id", "spec", "params", "lspec", "batches",
                 "t_max", "trainer", "lora", "opt_state", "tokens", "loss_mask",
                 "answer_pos", "pack", "ptokens", "pmask", "ppos", "psegs")


def _build_sft_state(ds: BlindDataset, cfg: RunConfig, device: torch.device) -> _SftRunState:
    st = _SftRunState()
    k = cfg.data.k
    st.tokenizer = build_tokenizer(cfg)
    st.tb = tokenize_dataset(ds, st.tokenizer, max_len=cfg.data.max_len,
                             include_context=cfg.data.include_context)
    st.fold_id = kfold_assign(ds, k, cfg.data.seed)
    st.spec, st.params = build_model(cfg, st.tokenizer, device)
    st.lspec = lora_spec_from_cfg(cfg, st.spec.dtype)
    st.pack = _pack_train_data(st.tb, st.fold_id, cfg) if cfg.optim.pack else None
    st.batches = _fold_batches(st, cfg, cfg.data.seed)
    # answer-window length: the longest target
    st.t_max = int(np.max(st.tb.lengths - st.tb.answer_pos - 1))
    st.trainer = FoldTrainer(
        st.spec, st.lspec, k, lr=cfg.optim.lr, total_steps=st.batches.shape[0],
        warmup_frac=cfg.optim.warmup_frac, weight_decay=cfg.optim.weight_decay,
        use_pallas=cfg.model.use_pallas, t_max=st.t_max, b1=cfg.optim.b1, b2=cfg.optim.b2,
        fused_mlp=cfg.model.fused_mlp, packed=st.pack is not None)
    st.lora, st.opt_state = st.trainer.init_state(
        torch.Generator(device=device).manual_seed(cfg.data.seed + 1))
    st.tokens = torch.from_numpy(st.tb.tokens).to(device)
    st.loss_mask = torch.from_numpy(st.tb.loss_mask).to(device)
    st.answer_pos = torch.from_numpy(st.tb.answer_pos).to(device)
    st.ptokens = st.pmask = st.ppos = st.psegs = None
    if st.pack is not None:
        st.ptokens, st.pmask, st.ppos, st.psegs = (
            torch.from_numpy(a).to(device) for a in (st.pack.tokens, st.pack.loss_mask,
                                                     st.pack.answer_pos, st.pack.seg_starts))
    return st


def _pack_train_data(tb, fold_id: np.ndarray, cfg: RunConfig) -> FoldPacked:
    """Per-fold packed train splits for ``optim.pack``; ``optim.pack_len`` 0
    means twice the tokenized bucket."""
    pack_len = int(cfg.optim.pack_len) or 2 * tb.seq_len
    if pack_len < tb.seq_len:
        raise ValueError(
            f"optim.pack_len {pack_len} < tokenized bucket {tb.seq_len} — "
            "the longest sample would not fit a packed row")
    return pack_fold_datasets(tb, fold_id, cfg.data.k, pack_len)


def _fold_batches(st: _SftRunState, cfg: RunConfig, seed: int) -> np.ndarray:
    """[steps, k, B] index streams over the dataset rows, or over each fold's
    packed rows."""
    if st.pack is not None:
        return make_packed_fold_batches(st.pack.n_rows, cfg.optim.batch_size,
                                        cfg.optim.epochs, seed, batch_multiple=cfg.mesh.data)
    return make_fold_batches(st.fold_id, cfg.data.k, cfg.optim.batch_size, cfg.optim.epochs,
                             seed, batch_multiple=cfg.mesh.data)


def run_sft_diagnostic(ds: BlindDataset, cfg: RunConfig,
                       device: torch.device) -> Dict[str, Any]:
    """The core diagnostic: k-fold blind LoRA SFT → held-out s(x) → report.
    Returns the report dict (artifacts on disk). Attention goes through the
    flash kernels, forward and backward, when ``model.use_pallas`` is on
    (their plain versions for CPU tensors) and the dense path otherwise;
    with ``model.fused_mlp`` the train step's MLP goes through the fused
    kernel. Numeric and open rows are greedy-decoded with each fold's
    adapter after training (int4 weights through K3)."""
    t_start = time.time()
    _check_sft_config(ds, cfg)
    k = cfg.data.k
    st = _build_sft_state(ds, cfg, device)
    setup_wall = time.time() - t_start
    tb, fold_id, spec, params, lspec = st.tb, st.fold_id, st.spec, st.params, st.lspec
    batches, trainer, lora, opt_state = st.batches, st.trainer, st.lora, st.opt_state
    use_pallas = cfg.model.use_pallas
    logger = JsonlLogger(cfg.out_dir)
    stage_walls: Dict[str, float] = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        stage_walls[name] = stage_walls.get(name, 0.0) + time.time() - t0
        return out

    single_token_opts = (tb.option_token_seqs is None
                         or tb.option_token_seqs.shape[-1] == 1)
    has_mcq = bool((tb.gold >= 0).any())
    # numeric and open rows are decode-scored (below), so the MCQ scorer's
    # grid holds the MCQ rows only
    mcq_fold_id = np.where(tb.gold >= 0, fold_id, -1)

    def score_mcq(lora_now):
        if not has_mcq:  # an all-numeric or all-open set: no letter columns
            return np.zeros((tb.n, 1), np.float32)
        if st.pack is not None and single_token_opts and cfg.optim.packed_scorer:
            return score_heldout_mcq_packed(params, lora_now, spec, lspec, tb, mcq_fold_id, k,
                                            pack_len=st.pack.pack_len, use_pallas=use_pallas)
        return score_heldout_mcq(params, lora_now, spec, lspec, st.tokens, st.answer_pos,
                                 tb.option_token_ids, tb.n_options, mcq_fold_id, k,
                                 use_pallas=use_pallas, option_seqs=tb.option_token_seqs)

    def score_now(lora_now):
        return timed("score_mcq", lambda: score_mcq(lora_now))

    # s(x) averages the final epoch of every seed and the epochs listed in
    # optim.score_epochs
    score_after = {int(e) for e in cfg.optim.score_epochs if 1 <= int(e) < cfg.optim.epochs}
    epoch_probs, seed_final_probs = [], []
    steps_per_epoch = max(batches.shape[0] // max(cfg.optim.epochs, 1), 1)
    n_seeds = max(int(cfg.optim.n_seeds), 1)
    if st.pack is not None:  # each fold's own packed rows
        train_data = dict(all_tokens=st.ptokens, all_mask=st.pmask, all_pos=st.ppos,
                          all_segs=st.psegs, n_segs=st.pack.n_segs)
    else:
        train_data = dict(all_tokens=st.tokens, all_mask=st.loss_mask, all_pos=st.answer_pos)
    tlog = None
    for s_i in range(n_seeds):
        if s_i > 0:  # fresh adapters and batch order, same folds
            lora, opt_state = trainer.init_state(
                torch.Generator(device=device).manual_seed(cfg.data.seed + 1 + 7919 * s_i))
            batches = _fold_batches(st, cfg, cfg.data.seed + s_i)
        for e in range(cfg.optim.epochs):
            chunk = batches[e * steps_per_epoch: (e + 1) * steps_per_epoch]
            if e == cfg.optim.epochs - 1:  # the last epoch takes any remainder
                chunk = batches[e * steps_per_epoch:]
            if chunk.shape[0] == 0:
                continue
            lora, opt_state, elog = trainer.fit(
                params, lora, opt_state, batches=chunk, log_every=cfg.log_every,
                log_fn=lambda step, loss: logger.log(event="train", seed=s_i, epoch=e,
                                                     step=step, loss=loss), **train_data)
            tlog = _merge_logs(tlog, elog)
            if (e + 1) in score_after:
                epoch_probs.append(score_now(lora))
        final = score_now(lora)
        epoch_probs.append(final)
        seed_final_probs.append(final)

    probs = np.mean(epoch_probs, axis=0) if len(epoch_probs) > 1 else epoch_probs[0]
    s_x = bias_scores(probs, tb.gold, tb.n_options, rule=cfg.rf.score_rule)
    pred = probs.argmax(-1).astype(np.int32)
    report = _sft_report(ds, cfg, tb, pred, seed_final_probs)

    # numeric (NA) rows: held-out greedy decode, per-sample MRA as their s(x)
    gold_values = gold_values_of(ds).astype(np.float32)
    decoded: Dict[str, Any] = {}
    if np.isfinite(gold_values).any():
        pred_values, s_num = timed("numeric_decode", lambda: score_heldout_numeric(
            params, lora, spec, lspec, st.tokens, st.answer_pos, gold_values, fold_id, k,
            tokenizer=st.tokenizer, use_pallas=use_pallas))
        s_x = np.where(np.isfinite(s_num), s_num, s_x)
        decoded["numeric_blind_mra"] = float(metrics.mra(np.nan_to_num(pred_values), gold_values))
        decoded["n_numeric"] = int(np.isfinite(gold_values).sum())
    # open rows: held-out greedy decode, normalized exact match as their s(x)
    gold_texts = gold_texts_of(ds)
    if any(g is not None for g in gold_texts):
        _, s_open = timed("open_decode", lambda: score_heldout_open(
            params, lora, spec, lspec, st.tokens, st.answer_pos, gold_texts, fold_id, k,
            tokenizer=st.tokenizer, use_pallas=use_pallas))
        s_x = np.where(np.isfinite(s_open), s_open, s_x)
        decoded["open_blind_accuracy"] = round(float(np.nanmean(s_open)), 4)
        decoded["n_open"] = int(sum(g is not None for g in gold_texts))
    # RF-vs-SFT agreement: the fast auditor and the SFT engine should rank
    # the same samples as biased; the host-side backend, on the merged s(x)
    if cfg.rf.cross_check and has_mcq:
        rf_d = timed("rf_cross_check", lambda: run_rf_diagnostic(
            ds, k=cfg.data.k, seed=cfg.data.seed, n_estimators=cfg.rf.n_estimators,
            max_depth=cfg.rf.max_depth, backend="sklearn", score_rule=cfg.rf.score_rule,
            device=device))
        report["rf_sft_spearman"] = round(spearman(rf_d.s_x, s_x), 4)
        report["rf_blind_accuracy"] = round(float(rf_d.blind_accuracy), 4)
    report.update(decoded)
    report.update(
        n_samples=len(ds),
        n_mcq=int((tb.gold >= 0).sum()),
        k=k,
        model=spec.name,
        fold_accuracies=[
            round(float(metrics.accuracy(pred[fold_id == f], tb.gold[fold_id == f])), 4)
            for f in range(k)],
        train_steps=tlog.steps,
        final_loss=tlog.losses[-1] if tlog.losses else None,
        train_wall_seconds=round(tlog.wall_seconds, 2),
        train_first_step_seconds=round(tlog.first_step_seconds, 2),
        train_samples_per_sec=round(tlog.samples_per_sec, 2),
        wall_seconds=round(time.time() - t_start, 2),
        setup_wall_seconds=round(setup_wall, 2),
        **{f"{name}_wall_seconds": round(w, 2) for name, w in sorted(stage_walls.items())},
    )
    if st.pack is not None:
        report["pack_len"] = st.pack.pack_len
        report["pack_fill_fraction"] = round(st.pack.fill_fraction, 4)
    outputs.write_sx_table(cfg.out_dir, ds, s_x, fold_id, pred=pred)
    outputs.write_report(cfg.out_dir, report)
    ds.save_jsonl(f"{cfg.out_dir}/dataset.jsonl")
    cfg.save(f"{cfg.out_dir}/config.json")
    logger.log(event="done", **{key: v for key, v in report.items()
                                if isinstance(v, (int, float, str))})
    logger.close()
    return report


def _sft_report(ds: BlindDataset, cfg: RunConfig, tb, pred: np.ndarray,
                seed_final_probs) -> Dict[str, Any]:
    """Blind accuracy, chance, per-category accuracy and the seed-stability
    fields that open the diagnose-sft report."""
    rule = cfg.rf.score_rule
    report = metrics.blind_report(float(metrics.accuracy(pred, tb.gold)),
                                  float(metrics.chance_accuracy(tb.n_options)), name=ds.name)
    cat_names = ds.categories
    cat_ids = np.array([cat_names.index(s.category) for s in ds])
    cat_acc = metrics.per_category_accuracy(pred, tb.gold, cat_ids, len(cat_names)).numpy()
    report["per_category_blind_accuracy"] = {
        c: round(float(a), 4) for c, a in zip(cat_names, cat_acc) if np.isfinite(a)}
    if len(seed_final_probs) > 1:
        # seed stability: mean pairwise Spearman of the per-seed s(x), and
        # the mean pairwise Jaccard of their top-q sets
        per_seed = [bias_scores(p, tb.gold, tb.n_options, rule=rule) for p in seed_final_probs]
        pairs = [(i, j) for i in range(len(per_seed)) for j in range(i + 1, len(per_seed))]
        rho = float(np.nanmean([spearman(per_seed[i], per_seed[j]) for i, j in pairs]))
        if np.isfinite(rho):
            report["sx_seed_spearman"] = round(rho, 4)
        mcq_rows = np.flatnonzero(tb.gold >= 0)

        def top_jaccard(q):
            m = max(int(round(q * len(mcq_rows))), 1)
            tops = [set(mcq_rows[np.argsort(-sx[mcq_rows], kind="stable")[:m]])
                    for sx in per_seed]
            return float(np.mean([len(tops[i] & tops[j]) / len(tops[i] | tops[j])
                                  for i, j in pairs]))

        if len(mcq_rows):
            report["sx_seed_top_jaccard"] = {"0.1": round(top_jaccard(0.1), 4),
                                             "0.2": round(top_jaccard(0.2), 4)}
    return report
