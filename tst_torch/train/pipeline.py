"""Run pipelines of the port (counterpart of ``tst/train/pipeline.py``):

  * the blind evaluation (``eval-blind``): load → blind-render → tokenize →
    model → single-forward MCQ scoring, greedy-decoded numeric (MRA) and
    open (exact match) rows → metrics → ``blind_eval.json``; zero-shot, or
    serving a trained adapter (``--adapter DIR --fold i|mean``);
  * the core diagnostic (``diagnose-sft``), unpacked or packed
    (``optim.pack``): tokenize → stratified k folds → fold-parallel LoRA SFT
    (checkpointed under ``checkpoint_dir``, resumed from it) → held-out
    scoring with each fold's adapter (MCQ rows by one forward, numeric and
    open rows by greedy decode) → s(x) → metrics → ``report.json``,
    ``sx.jsonl``, ``dataset.jsonl``, ``config.json``, ``events.jsonl``;
  * ``generate``: greedy continuations of every prompt, from the base or a
    served adapter, plain or by exact speculative decoding with a draft
    model → ``generations.jsonl``, ``generate_report.json``;
  * ``warmup``: builds every CUDA extension a diagnose-sft run of the config
    would launch.

They take a quantized base (``model.quantize`` int8 / int4, decoded through
the int4 kernel K3), ``model.fused_mlp`` (the fused SwiGLU kernel K4 in
training), LoRA dropout and ``perf.spec_draft_*`` (exact speculative decode
of the numeric and open rows).

Every pipeline runs under the mesh of ``cfg.mesh`` (tst_torch.runtime.mesh):
launched by ``torchrun`` with one rank a card, each rank builds or loads
only its shards, trains its folds and its rows, and scores and decodes its
share; the numbers every rank ends with are the whole run's, and only rank
0 writes artifacts and logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tst_torch.aux.ckpt import EXTRA_FILE, load_train_state
from tst_torch.aux.log import JsonlLogger
from tst_torch.aux.profile import trace
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
from tst_torch.models.decode import decode_numeric, decode_text, greedy_decode
from tst_torch.models.decoder import Params, check_tensor_widths, init_params
from tst_torch.models.hf_load import load_checkpoint, spec_from_hf_config
from tst_torch.models.lora import LoraSpec, lora_shapes
from tst_torch.models.quant import quantize_params, quantized_bytes, quantizing_put
from tst_torch.models.spec import ModelSpec, spec_by_name
from tst_torch.models.spec_decode import speculative_greedy_decode
from tst_torch.runtime import mesh as mesh_mod
from tst_torch.train.infer import (decode_chunk_rows, score_all_mcq, score_heldout_mcq,
                                   score_heldout_mcq_packed, score_heldout_numeric,
                                   score_heldout_open)
from tst_torch.train.sft import FoldTrainer, TrainLog, make_fold_batches

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run_mesh(cfg: RunConfig):
    """The run's mesh: joins the process group of a launch over several
    ranks (torchrun's variables; a no-op for one process), then builds
    ``cfg.mesh`` over its ranks; None for a mesh of one. Raises when the
    mesh needs more ranks than the launch has."""
    mesh_mod.init_distributed()
    mesh = mesh_mod.from_config(cfg.mesh)
    return mesh if mesh_mod.active(mesh) else None


class _NoLog:
    """The event log of a rank that does not write."""

    def log(self, **fields: Any) -> None:
        pass

    def close(self) -> None:
        pass


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


def model_spec(cfg: RunConfig, tokenizer) -> ModelSpec:
    """The run's ModelSpec in its dtype: from ``model.path``'s config.json,
    else the named geometry, its vocabulary widened to the tokenizer's."""
    dtype = DTYPES[cfg.model.dtype]
    if cfg.model.path:
        return dataclasses.replace(spec_from_hf_config(cfg.model.path, name=cfg.model.name),
                                   dtype=dtype)
    spec = spec_by_name(cfg.model.name, dtype=dtype)
    if spec.vocab_size < tokenizer.vocab_size:
        spec = spec_by_name(cfg.model.name, dtype=dtype, vocab_size=tokenizer.vocab_size)
    return spec


def build_model(cfg: RunConfig, tokenizer, device: torch.device,
                mesh=None) -> Tuple[ModelSpec, Params]:
    """ModelSpec + params on ``device``: the HF checkpoint of ``model.path``,
    streamed tensor by tensor (the spec from its config.json, in the run's
    dtype; ``model.quantize`` int8 / int4 quantizes each tensor as it
    arrives, through ``quantizing_put``), else a random init from a
    generator seeded with ``data.seed``, quantized after the init, leaf by
    leaf (tst_torch.models.quant). ``mesh``: this rank's shards only (a
    checkpoint's tensors are cut as they arrive; a random init keeps the
    rank's slice of each leaf); a width the tensor axis does not divide
    raises."""
    dtype = DTYPES[cfg.model.dtype]
    quant_bits = {"none": None, "int8": 8, "int4": 4}.get(cfg.model.quantize, -1)
    if quant_bits == -1:
        raise ValueError(f"unknown model.quantize {cfg.model.quantize!r}")
    spec = model_spec(cfg, tokenizer)
    if mesh is not None:
        check_tensor_widths(spec, mesh.size("tensor"))
    if cfg.model.path:
        put = quantizing_put(dtype, bits=quant_bits) if quant_bits is not None else None
        return spec, load_checkpoint(cfg.model.path, spec, dtype=dtype, put=put, device=device,
                                     mesh=mesh)
    rng = torch.Generator(device=device).manual_seed(cfg.data.seed)
    params = init_params(rng, spec)
    if quant_bits is not None:
        params = quantize_params(params, bits=quant_bits)
    if mesh is not None:
        params = mesh_mod.shard_tree(params, mesh_mod.param_pspec_tree(params), mesh)
    return spec, params


def build_draft_model(cfg: RunConfig, tokenizer, device: torch.device, mesh=None):
    """(draft_spec, draft_params) for ``perf.spec_draft_*``, or None. The
    draft shares the target's tokenizer (exact speculative decoding needs
    it) and is base-weighted: it never sees adapters. Sharded as the
    target under ``mesh``."""
    if not (cfg.perf.spec_draft_model or cfg.perf.spec_draft_path):
        return None
    dcfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, name=cfg.perf.spec_draft_model or cfg.model.name,
        path=cfg.perf.spec_draft_path, quantize=cfg.perf.spec_draft_quantize))
    return build_model(dcfg, tokenizer, device, mesh=mesh)


def _has_decoded_rows(ds: BlindDataset) -> bool:
    return (np.isfinite(gold_values_of(ds)).any()
            or any(g is not None for g in gold_texts_of(ds)))


def gold_values_of(ds: BlindDataset) -> np.ndarray:
    """[N] numeric gold answers, NaN on other rows."""
    return np.asarray([s.answer_value if s.answer_type == NUMERIC else np.nan for s in ds],
                      np.float64)


def gold_texts_of(ds: BlindDataset) -> list:
    """[N] open gold answers, None on other rows."""
    return [s.answer if s.answer_type == OPEN else None for s in ds]


def prepare_blind_eval(ds: BlindDataset, cfg: RunConfig, device: torch.device, mesh=None):
    """(TokenBatch, tokens, answer_pos, spec, params): the tokenized set with
    its tokens and answer positions on ``device``, and the model (this
    rank's shards under ``mesh``)."""
    tokenizer = build_tokenizer(cfg)
    tb = tokenize_dataset(ds, tokenizer, max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    spec, params = build_model(cfg, tokenizer, device, mesh=mesh)
    return (tb, torch.from_numpy(tb.tokens).to(device),
            torch.from_numpy(tb.answer_pos).to(device), spec, params)


def run_blind_eval(ds: BlindDataset, cfg: RunConfig, device: torch.device,
                   adapter_dir: Optional[str] = None, fold: str = "0",
                   full_accuracy: Optional[float] = None) -> Dict[str, Any]:
    """Blind scoring of every sample: with the base model, the zero-shot
    baseline leg of the vision-blind gap, or with ``adapter_dir`` a trained
    LoRA checkpoint (the serving leg: adapters trained once are evaluated
    anywhere). ``fold`` picks the adapter that serves: a fold index, or
    ``"mean"`` for the mean of the folds' adapters. ``full_accuracy`` (the
    with-vision accuracy, measured elsewhere) adds ``vision_blind_gap`` to
    the report. Attention goes through the flash kernel when
    ``model.use_pallas`` is on (its plain version for CPU tensors) and the
    dense path otherwise; numeric and open rows are greedy-decoded through
    the same adapter (int4 weights through K3), by exact speculative decode
    with ``perf.spec_draft_*``."""
    t_start = time.time()
    mesh = run_mesh(cfg)
    tb, tokens, answer_pos, spec, params = prepare_blind_eval(ds, cfg, device, mesh=mesh)
    use_pallas = cfg.model.use_pallas
    one = lspec = None
    if adapter_dir:
        one, lspec = load_adapter_lora(adapter_dir, cfg, spec, fold=fold, device=device)
        one = mesh_mod.local_lora(one, mesh, folds=False)
    zero_folds = np.zeros(tb.n, np.int32)
    # the MCQ leg only when the set has options (an all-numeric or all-open
    # set has none)
    if int(np.max(tb.n_options, initial=0)) > 0:
        if adapter_dir:
            probs = score_heldout_mcq(params, one, spec, lspec, tokens, answer_pos,
                                      tb.option_token_ids, tb.n_options, zero_folds, 1,
                                      use_pallas=use_pallas, option_seqs=tb.option_token_seqs,
                                      mesh=mesh)
        else:
            probs = score_all_mcq(params, spec, tokens, answer_pos, tb.option_token_ids,
                                  tb.n_options, use_pallas=use_pallas,
                                  option_seqs=tb.option_token_seqs, mesh=mesh)
        pred = probs.argmax(-1).astype(np.int32)
        blind_acc = float(metrics.accuracy(pred, tb.gold))
        chance = float(metrics.chance_accuracy(tb.n_options))
    else:
        blind_acc, chance = 0.0, 0.0
    report = metrics.blind_report(blind_acc, chance, full_acc=full_accuracy,
                                  name=ds.name)
    report["n_mcq"] = int((np.asarray(tb.n_options) > 0).sum())
    tokenizer = build_tokenizer(cfg)
    draft = (build_draft_model(cfg, tokenizer, device, mesh=mesh) if _has_decoded_rows(ds)
             else None)
    decode_kw = dict(tokenizer=tokenizer, use_pallas=use_pallas, draft=draft,
                     gamma=cfg.perf.spec_gamma, mesh=mesh)
    gold_texts = gold_texts_of(ds)
    if any(g is not None for g in gold_texts):
        _, s_open = score_heldout_open(params, one, spec, lspec, tokens, answer_pos, gold_texts,
                                       zero_folds, 1, **decode_kw)
        report["open_blind_accuracy"] = round(float(np.nanmean(s_open)), 4)
        report["n_open"] = int(sum(g is not None for g in gold_texts))
    # numeric (NA) rows: greedy decode → MRA, the VSI-Bench numeric metric
    gold_values = gold_values_of(ds)
    if np.isfinite(gold_values).any():
        pred_values, _ = score_heldout_numeric(params, one, spec, lspec, tokens, answer_pos,
                                               gold_values, zero_folds, 1, **decode_kw)
        report["numeric_blind_mra"] = round(
            float(metrics.mra(np.nan_to_num(pred_values), gold_values)), 4)
        report["n_numeric"] = int(np.isfinite(gold_values).sum())
    report.update(n_samples=len(ds), model=spec.name, zero_shot=adapter_dir is None,
                  adapter=adapter_dir, adapter_fold=fold if adapter_dir else None,
                  wall_seconds=round(time.time() - t_start, 2))
    if mesh_mod.is_main():
        outputs.write_report(cfg.out_dir, report, name="blind_eval.json")
    return report


def _read_adapter_meta(adapter_dir: str, cfg: RunConfig, dtype: torch.dtype
                       ) -> Tuple[int, LoraSpec]:
    """(k, LoraSpec) of a served checkpoint, from its extra.json stamp
    (``FoldTrainer.ckpt_extra``), so an adapter trained with any k is read
    whatever the serving config says. A checkpoint without the stamp, or a
    legacy stamp without ``k``, falls back to the serving config. A stamp
    naming another model than the serving config's raises."""
    meta_path = os.path.join(adapter_dir, EXTRA_FILE)
    if not os.path.exists(meta_path):
        return cfg.data.k, lora_spec_from_cfg(cfg, dtype)
    with open(meta_path) as f:
        extra = json.load(f)
    if "k" not in extra:  # a legacy stamp with only {"step": N}
        return cfg.data.k, lora_spec_from_cfg(cfg, dtype)
    if extra.get("model_name") and cfg.model.name != extra["model_name"]:
        raise ValueError(
            f"adapter {adapter_dir} was trained on model {extra['model_name']!r} but serving "
            f"config says {cfg.model.name!r} — pass the matching --set model.name")
    lspec = LoraSpec(rank=int(extra["lora_rank"]), alpha=float(extra["lora_alpha"]),
                     targets=tuple(extra["lora_targets"]), dtype=dtype)
    return int(extra["k"]), lspec


def fold_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, 0, keepdims=True)`` as XLA computes it on the CPU, bit
    for bit in bf16 and f32: the fold slices summed one after another in
    f32, times the f32 reciprocal of k, cast back to x's dtype."""
    acc = x[0].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i].float()
    return (acc * torch.tensor(1.0 / x.shape[0], dtype=torch.float32)).to(x.dtype)[None]


def load_adapter_lora(adapter_dir: str, cfg: RunConfig, spec: ModelSpec, fold: str = "0",
                      keep_fold_axis: bool = True, device: torch.device | str = "cpu"):
    """A fold-stacked LoRA checkpoint (tst_torch.aux.ckpt) read for serving
    → (adapter, lspec), on ``device``.

    k and the LoRA geometry come from the checkpoint's own stamp
    (:func:`_read_adapter_meta`). ``fold`` picks the adapter that serves: an
    index, or ``"mean"`` for the mean of the folds' adapters in the
    adapter's dtype (all folds share the zero-init-B parametrization).
    ``keep_fold_axis``: True gives a [1, ...] fold axis (the k=1 scorers'
    shape), False none (the decoders' shape)."""
    k_ckpt, lspec = _read_adapter_meta(adapter_dir, cfg, spec.dtype)
    like = {proj: {n: torch.empty((k_ckpt,) + shape, dtype=lspec.dtype, device=device)
                   for n, shape in shapes.items()}
            for proj, shapes in lora_shapes(spec, lspec).items()}
    lora_k, _, _ = load_train_state(adapter_dir, like)
    if fold == "mean":
        one = {p: {n: fold_mean(t) for n, t in ab.items()} for p, ab in lora_k.items()}
    else:
        f = int(fold)
        if not 0 <= f < k_ckpt:
            raise ValueError(f"--fold {f} out of range: checkpoint has k={k_ckpt}")
        one = {p: {n: t[f: f + 1] for n, t in ab.items()} for p, ab in lora_k.items()}
    if not keep_fold_axis:
        one = {p: {n: t[0] for n, t in ab.items()} for p, ab in one.items()}
    return one, lspec


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


class _SftRunState:
    """Everything a diagnose-sft run constructs before its first step."""

    __slots__ = ("tokenizer", "tb", "fold_id", "mesh", "spec", "params", "lspec", "batches",
                 "t_max", "trainer", "lora", "opt_state", "tokens", "loss_mask",
                 "answer_pos", "pack", "ptokens", "pmask", "ppos", "psegs")


def _build_sft_state(ds: BlindDataset, cfg: RunConfig, device: torch.device) -> _SftRunState:
    st = _SftRunState()
    k = cfg.data.k
    st.tokenizer = build_tokenizer(cfg)
    st.tb = tokenize_dataset(ds, st.tokenizer, max_len=cfg.data.max_len,
                             include_context=cfg.data.include_context)
    st.fold_id = kfold_assign(ds, k, cfg.data.seed)
    st.mesh = run_mesh(cfg)
    st.spec, st.params = build_model(cfg, st.tokenizer, device, mesh=st.mesh)
    st.lspec = lora_spec_from_cfg(cfg, st.spec.dtype)
    st.pack = _pack_train_data(st.tb, st.fold_id, cfg) if cfg.optim.pack else None
    st.batches = _fold_batches(st, cfg, cfg.data.seed)
    # answer-window length: the longest target
    st.t_max = int(np.max(st.tb.lengths - st.tb.answer_pos - 1))
    st.trainer = FoldTrainer(
        st.spec, st.lspec, k, lr=cfg.optim.lr, total_steps=st.batches.shape[0],
        warmup_frac=cfg.optim.warmup_frac, weight_decay=cfg.optim.weight_decay,
        use_pallas=cfg.model.use_pallas, remat=cfg.model.remat, mesh=st.mesh, t_max=st.t_max,
        ring=cfg.mesh.seq > 1, b1=cfg.optim.b1, b2=cfg.optim.b2,
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
    adapter after training (int4 weights through K3; by exact speculative
    decode with ``perf.spec_draft_*``). With ``checkpoint_dir`` each epoch
    of each seed checkpoints into ``{checkpoint_dir}/seed_{s}_epoch_{e:03d}``
    (the reference's layout), and a run that finds one resumes from it."""
    t_start = time.time()
    k = cfg.data.k
    st = _build_sft_state(ds, cfg, device)
    setup_wall = time.time() - t_start
    tb, fold_id, spec, params, lspec = st.tb, st.fold_id, st.spec, st.params, st.lspec
    batches, trainer, lora, opt_state = st.batches, st.trainer, st.lora, st.opt_state
    use_pallas = cfg.model.use_pallas
    mesh = st.mesh
    logger = JsonlLogger(cfg.out_dir) if mesh_mod.is_main() else _NoLog()
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
                                            pack_len=st.pack.pack_len, use_pallas=use_pallas,
                                            mesh=mesh)
        return score_heldout_mcq(params, lora_now, spec, lspec, st.tokens, st.answer_pos,
                                 tb.option_token_ids, tb.n_options, mcq_fold_id, k,
                                 use_pallas=use_pallas, option_seqs=tb.option_token_seqs,
                                 mesh=mesh)

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
    with trace(cfg.profile_dir):
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
                                                         step=step, loss=loss),
                    checkpoint_dir=(f"{cfg.checkpoint_dir}/seed_{s_i}_epoch_{e:03d}"
                                    if cfg.checkpoint_dir else None), **train_data)
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
    # perf.spec_draft_*: built only when a decode leg runs
    draft = (build_draft_model(cfg, st.tokenizer, device, mesh=mesh) if _has_decoded_rows(ds)
             else None)
    decode_kw = dict(tokenizer=st.tokenizer, use_pallas=use_pallas, draft=draft,
                     gamma=cfg.perf.spec_gamma, mesh=mesh)
    if np.isfinite(gold_values).any():
        pred_values, s_num = timed("numeric_decode", lambda: score_heldout_numeric(
            params, lora, spec, lspec, st.tokens, st.answer_pos, gold_values, fold_id, k,
            **decode_kw))
        s_x = np.where(np.isfinite(s_num), s_num, s_x)
        decoded["numeric_blind_mra"] = float(metrics.mra(np.nan_to_num(pred_values), gold_values))
        decoded["n_numeric"] = int(np.isfinite(gold_values).sum())
    # open rows: held-out greedy decode, normalized exact match as their s(x)
    gold_texts = gold_texts_of(ds)
    if any(g is not None for g in gold_texts):
        _, s_open = timed("open_decode", lambda: score_heldout_open(
            params, lora, spec, lspec, st.tokens, st.answer_pos, gold_texts, fold_id, k,
            **decode_kw))
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
    if mesh_mod.is_main():
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


def run_generate(ds: BlindDataset, cfg: RunConfig, device: torch.device, max_new: int = 16,
                 draft_model: Optional[str] = None, draft_path: Optional[str] = None,
                 draft_quantize: Optional[str] = None, gamma: int = 4,
                 adapter_dir: Optional[str] = None, fold: str = "0") -> Dict[str, Any]:
    """Greedy continuations of every sample's blind prompt (``generate``),
    the serving surface of the decode stack.

    With a draft model (``draft_model`` / ``draft_path``, stored as
    ``draft_quantize``) the run uses exact speculative decoding
    (tst_torch.models.spec_decode): the same tokens as the plain run, and
    the report carries the measured acceptance. The draft must share the
    target's tokenizer. With ``adapter_dir`` the target serves a trained
    LoRA checkpoint, ``fold`` picking the adapter as eval-blind's ``--fold``
    does; the draft stays base-weighted.

    Rows are decoded in chunks of ``decode_chunk_rows`` rows, the tail chunk
    padded with copies of its last row, as in the reference. Artifacts:
    ``generations.jsonl`` (id, answer_type, text, the parsed value of
    numeric rows) and ``generate_report.json``: the reference's fields, and
    ``decode_seconds``, the synchronized wall of the decode chunks alone
    (the tokens/s the serving path delivers, set-up left out)."""
    t_start = time.time()
    mesh = run_mesh(cfg)
    tokenizer = build_tokenizer(cfg)
    tb = tokenize_dataset(ds, tokenizer, max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    spec, params = build_model(cfg, tokenizer, device, mesh=mesh)
    use_pallas = cfg.model.use_pallas
    base_bytes = quantized_bytes(params)
    dspec = dparams = None
    if draft_model or draft_path:
        dcfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, name=draft_model or cfg.model.name, path=draft_path,
            quantize=draft_quantize or "none"))
        dspec, dparams = build_model(dcfg, tokenizer, device, mesh=mesh)
        base_bytes += quantized_bytes(dparams)
    lora = lspec = None
    if adapter_dir:
        lora, lspec = load_adapter_lora(adapter_dir, cfg, spec, fold=fold, keep_fold_axis=False,
                                        device=device)
        lora = mesh_mod.local_lora(lora, mesh, with_fold_axis=False)
    chunk = min(decode_chunk_rows(spec, tb.seq_len, max_new, k=1, base_bytes=base_bytes), tb.n)
    data = mesh.size("data") if mesh is not None else 1
    chunk += (-chunk) % data  # every data rank decodes its share of a chunk
    tokens = torch.from_numpy(tb.tokens).to(device)
    prompt_len = torch.from_numpy(tb.answer_pos).to(device).long() + 1

    gen = np.zeros((tb.n, max_new), np.int32)
    rounds_total = 0
    committed_total = 0.0  # tokens committed through rounds, real rows
    round_rows = 0  # over chunks: real rows x that chunk's rounds
    t_first = None
    t_decode = time.time()
    for lo in range(0, tb.n, chunk):
        n_real = min(lo + chunk, tb.n) - lo
        rows = np.arange(lo, lo + n_real)
        if rows.size < chunk:  # pad the tail chunk with its last row
            rows = np.pad(rows, (0, chunk - rows.size), mode="edge")
        sel = torch.from_numpy(rows).to(device)
        if data > 1:  # this rank's share of the chunk
            per = chunk // data
            sel = sel[mesh.index("data") * per: (mesh.index("data") + 1) * per]
        t0 = time.time()
        if dparams is not None:
            out, stats = speculative_greedy_decode(
                dparams, dspec, params, spec, tokens[sel], prompt_len[sel], max_new,
                gamma=gamma, lora=lora, lora_spec=lspec, use_pallas=use_pallas,
                return_stats=True, mesh=mesh)
            committed = stats["committed"]
            if data > 1:
                committed = mesh_mod.gather_leaf(committed, ("data",), mesh)
            rounds_total += stats["rounds"]
            # a full row keeps counting, so committed - 1 over the real rows
            # is the unbiased tokens-a-round count
            committed_total += float(committed[:n_real].sum().item() - n_real)
            round_rows += n_real * stats["rounds"]
        else:
            out = greedy_decode(params, tokens[sel], prompt_len[sel], max_new, spec, lora=lora,
                                lora_spec=lspec, use_pallas=use_pallas, mesh=mesh)
        if data > 1:
            out = mesh_mod.gather_leaf(out, ("data",), mesh)
        out = out.cpu().numpy()
        if t_first is None:
            t_first = time.time() - t0
        gen[lo: lo + chunk] = out[: tb.n - lo]
    decode_seconds = time.time() - t_decode

    texts = decode_text(gen, tokenizer)
    values = decode_numeric(gen, tokenizer)
    if mesh_mod.is_main():
        os.makedirs(cfg.out_dir, exist_ok=True)
        with open(f"{cfg.out_dir}/generations.jsonl", "w") as f:
            for sample, text, val in zip(ds, texts, values):
                row = {"id": sample.id, "answer_type": sample.answer_type, "text": text}
                if sample.answer_type == NUMERIC:
                    row["value"] = None if np.isnan(val) else float(val)
                f.write(json.dumps(row) + "\n")

    report: Dict[str, Any] = {
        "n_samples": len(ds), "model": spec.name, "max_new": max_new,
        "chunk_rows": int(chunk),
        "first_call_seconds": round(t_first or 0.0, 2),
        "tokens_generated": int(tb.n * max_new),
        "decode_seconds": round(decode_seconds, 4),
        "wall_seconds": round(time.time() - t_start, 2),
        "adapter": adapter_dir,
        "adapter_fold": fold if adapter_dir else None,
    }
    if dparams is not None:
        # tokens a row commits a round (1: the bonus only; gamma + 1: all
        # proposals accepted)
        per_round = committed_total / max(round_rows, 1)
        report.update(draft=dspec.name, gamma=gamma, spec_rounds=int(rounds_total),
                      committed_per_round=round(per_round, 3),
                      draft_acceptance=round(max(per_round - 1.0, 0.0) / gamma, 3))
    if mesh_mod.is_main():
        outputs.write_report(cfg.out_dir, report, name="generate_report.json")
    return report


#: the CUDA entry points of tst_torch/csrc each kind of launch needs
_K1 = ("tst_flash_attention_fwd", "tst_flash_attention_bwd_dkv", "tst_flash_attention_bwd_dq")
_K1_SEG = tuple(e + "_seg" for e in _K1)
_K3 = ("tst_int4_matmul",)
_K4 = ("tst_swiglu_gate_up", "tst_swiglu_down")
_DECODE_ATTENTION = ("tst_decode_attention",)


def warmup_entries(cfg: RunConfig, decodes: bool = False) -> list:
    """The CUDA entry points a diagnose-sft (or debias-ibp) run of ``cfg``
    would launch: K1's forward, dK/dV and dQ with ``model.use_pallas``, and
    their segmented variants with ``optim.pack``; K3 with an int4 base; K4
    with ``model.fused_mlp`` when no adapter targets the MLP; the decode
    step's attention kernel when the set has decode-scored rows
    (``decodes``)."""
    if not cfg.model.use_pallas:
        return []
    entries = list(_K1)
    if cfg.optim.pack:
        entries += _K1_SEG
    if cfg.model.quantize == "int4":
        entries += _K3
    mlp_lora = any(t in cfg.lora.targets for t in ("gate_proj", "up_proj", "down_proj"))
    if cfg.model.fused_mlp and not mlp_lora:
        entries += _K4
    if decodes:
        entries += _DECODE_ATTENTION
    return entries


def run_warmup(ds: BlindDataset, cfg: RunConfig, device: torch.device,
               ibp: bool = False) -> Dict[str, Any]:
    """Build, or find already built, every CUDA kernel a ``diagnose-sft``
    run of this config would launch (``debias-ibp`` with ``ibp``), and
    resolve each entry point (``warmup``).

    The reference AOT-compiles the run's XLA programs into its compilation
    cache; eager torch compiles no programs, so what a first run pays for
    here is the kernels' ``nvcc`` build (tst_torch.kernels._build, one
    library keyed by a hash of the sources). The report keeps the
    reference's keys that still mean something: ``model``, ``k``,
    ``seq_len``, ``n_samples``, ``target`` and ``wall_seconds``. Its
    ``train_step_compile_s``, ``scorer_compile_s`` and
    ``decode_{numeric,open}_compile_s`` have no counterpart; in their place
    ``kernels`` lists the entry points resolved, ``build_seconds`` the nvcc
    wall (0.0 when the library was built already) and ``library`` its file.
    ``--platform cpu`` builds nothing (CPU tensors take the plain
    versions), and the report says so."""
    t_start = time.time()
    run_mesh(cfg)
    tokenizer = build_tokenizer(cfg)
    tb = tokenize_dataset(ds, tokenizer, max_len=cfg.data.max_len,
                          include_context=cfg.data.include_context)
    spec = model_spec(cfg, tokenizer)
    report: Dict[str, Any] = {"model": spec.name, "k": cfg.data.k, "seq_len": tb.seq_len,
                              "n_samples": len(ds),
                              "target": "debias-ibp" if ibp else "diagnose-sft"}
    entries = warmup_entries(cfg, decodes=_has_decoded_rows(ds))
    if device.type != "cuda":
        report.update(kernels=[], build_seconds=0.0, library=None,
                      note="--platform cpu: nothing to build; CPU tensors take the kernels' "
                           "plain versions")
    else:
        from tst_torch.kernels import _build

        res = _build.build()
        lib = _build.library()
        for entry in entries:
            getattr(lib, entry)  # resolves the symbol, or raises AttributeError
        report.update(kernels=entries, build_seconds=round(res.seconds, 2),
                      library=res.path.name)
    report["wall_seconds"] = round(time.time() - t_start, 2)
    if mesh_mod.is_main():
        outputs.write_report(cfg.out_dir, report, name="warmup_report.json")
    return report
