"""Train-transfer (counterpart of ``tst/train/transfer.py``): fine-tune on a
training set, blind-evaluate a test set.

If blind accuracy on the test set rises after fine-tuning on independent
training data, the model learns the task's text priors; if it rises only
when fine-tuning on the test set itself (``diagnose-sft``), the benchmark
leaks test-set shortcuts. The report carries the trained adapter's scores,
the zero-shot scores of the same eval set and their deltas.

The fold machinery runs with k=1 and every training row in the train
stream (fold id -1 never matches fold 0), unpacked or packed
(``optim.pack``); then the eval set's MCQ rows are scored by one forward
each and its numeric and open rows greedy-decoded (by exact speculative
decode with ``perf.spec_draft_*``), once with the trained adapter and once
without.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from tst_torch.config import RunConfig
from tst_torch.data.packing import make_packed_fold_batches, pack_fold_datasets
from tst_torch.data.schema import BlindDataset
from tst_torch.data.tokenize import tokenize_dataset
from tst_torch.eval import metrics
from tst_torch.io import outputs
from tst_torch.runtime.mesh import is_main
from tst_torch.train.infer import score_heldout_mcq, score_heldout_numeric, score_heldout_open
from tst_torch.train.pipeline import (build_draft_model, build_model, build_tokenizer,
                                      gold_texts_of, gold_values_of, lora_spec_from_cfg,
                                      run_mesh)
from tst_torch.train.sft import FoldTrainer, make_fold_batches


def run_train_transfer(train_ds: BlindDataset, eval_ds: BlindDataset, cfg: RunConfig,
                       device: torch.device) -> Dict[str, Any]:
    """SFT on ``train_ds`` (every row), blind-score ``eval_ds`` with the
    trained adapter and zero-shot → the report (``transfer_report.json``)."""
    t_start = time.time()
    mesh = run_mesh(cfg)
    tokenizer = build_tokenizer(cfg)
    tb_train = tokenize_dataset(train_ds, tokenizer, max_len=cfg.data.max_len,
                                include_context=cfg.data.include_context)
    tb_eval = tokenize_dataset(eval_ds, tokenizer, max_len=cfg.data.max_len,
                               include_context=cfg.data.include_context)
    spec, params = build_model(cfg, tokenizer, device, mesh=mesh)
    lspec = lora_spec_from_cfg(cfg, spec.dtype)

    # k=1, every row trains: fold ids of -1 never match fold 0
    pseudo_fold = np.full(tb_train.n, -1, np.int32)
    pack = None
    if cfg.optim.pack:
        pack = pack_fold_datasets(tb_train, pseudo_fold, 1,
                                  int(cfg.optim.pack_len) or 2 * tb_train.seq_len)
        batches = make_packed_fold_batches(pack.n_rows, cfg.optim.batch_size, cfg.optim.epochs,
                                           cfg.data.seed, batch_multiple=cfg.mesh.data)
    else:
        batches = make_fold_batches(pseudo_fold, 1, cfg.optim.batch_size, cfg.optim.epochs,
                                    cfg.data.seed, batch_multiple=cfg.mesh.data)
    t_max = int(max(np.max(tb_train.lengths - tb_train.answer_pos - 1),
                    np.max(tb_eval.lengths - tb_eval.answer_pos - 1)))
    use_pallas = cfg.model.use_pallas
    trainer = FoldTrainer(
        spec, lspec, k=1, lr=cfg.optim.lr, total_steps=batches.shape[0],
        warmup_frac=cfg.optim.warmup_frac, weight_decay=cfg.optim.weight_decay,
        use_pallas=use_pallas, remat=cfg.model.remat, mesh=mesh, t_max=t_max,
        ring=cfg.mesh.seq > 1, b1=cfg.optim.b1, b2=cfg.optim.b2, packed=pack is not None)
    lora, opt = trainer.init_state(torch.Generator(device=device).manual_seed(cfg.data.seed + 1))
    if pack is not None:
        lora, opt, tlog = trainer.fit(
            params, lora, opt, *(torch.from_numpy(a).to(device)
                                 for a in (pack.tokens, pack.loss_mask)), batches,
            all_pos=torch.from_numpy(pack.answer_pos).to(device),
            all_segs=torch.from_numpy(pack.seg_starts).to(device), n_segs=pack.n_segs,
            log_every=cfg.log_every)
    else:
        lora, opt, tlog = trainer.fit(
            params, lora, opt, *(torch.from_numpy(a).to(device)
                                 for a in (tb_train.tokens, tb_train.loss_mask)), batches,
            all_pos=torch.from_numpy(tb_train.answer_pos).to(device), log_every=cfg.log_every)

    # the eval set with the trained adapter (every row "held out") and zero-shot
    tokens_ev = torch.from_numpy(tb_eval.tokens).to(device)
    pos_ev = torch.from_numpy(tb_eval.answer_pos).to(device)
    eval_fold0 = np.zeros(tb_eval.n, np.int32)
    draft = build_draft_model(cfg, tokenizer, device, mesh=mesh)
    decode_kw = dict(tokenizer=tokenizer, use_pallas=use_pallas, draft=draft,
                     gamma=cfg.perf.spec_gamma, mesh=mesh)
    gold_values = gold_values_of(eval_ds)
    gold_texts = gold_texts_of(eval_ds)

    def score_all(lora_or_none, lspec_or_none) -> Dict[str, Any]:
        leg: Dict[str, Any] = {}
        if int(np.max(tb_eval.n_options, initial=0)) > 0:
            probs = score_heldout_mcq(params, lora_or_none, spec, lspec_or_none, tokens_ev,
                                      pos_ev, tb_eval.option_token_ids, tb_eval.n_options,
                                      eval_fold0, 1, use_pallas=use_pallas,
                                      option_seqs=tb_eval.option_token_seqs, mesh=mesh)
            pred = probs.argmax(-1).astype(np.int32)
            mcq_rows = np.asarray(tb_eval.n_options) > 0
            leg["blind_accuracy"] = float(metrics.accuracy(pred[mcq_rows],
                                                           tb_eval.gold[mcq_rows]))
            leg["n_mcq"] = int(mcq_rows.sum())
        if np.isfinite(gold_values).any():
            pred_values, _ = score_heldout_numeric(params, lora_or_none, spec, lspec_or_none,
                                                   tokens_ev, pos_ev, gold_values, eval_fold0,
                                                   1, **decode_kw)
            leg["numeric_blind_mra"] = round(
                float(metrics.mra(np.nan_to_num(pred_values), gold_values)), 4)
            leg["n_numeric"] = int(np.isfinite(gold_values).sum())
        if any(g is not None for g in gold_texts):
            _, s_open = score_heldout_open(params, lora_or_none, spec, lspec_or_none, tokens_ev,
                                           pos_ev, gold_texts, eval_fold0, 1, **decode_kw)
            leg["open_blind_accuracy"] = round(float(np.nanmean(s_open)), 4)
            leg["n_open"] = int(sum(g is not None for g in gold_texts))
        return leg

    post = score_all(lora, lspec)
    zero = score_all(None, None)
    report = metrics.blind_report(post.get("blind_accuracy", 0.0),
                                  float(metrics.chance_accuracy(tb_eval.n_options)),
                                  name=eval_ds.name)
    report.update(post)
    report.update({f"zero_shot_{key}": v for key, v in zero.items()})
    for key in ("blind_accuracy", "numeric_blind_mra", "open_blind_accuracy"):
        if key in post and f"zero_shot_{key}" in report:
            report[f"transfer_delta_{key}"] = round(post[key] - report[f"zero_shot_{key}"], 4)
    report.update(
        experiment="train_transfer",
        train_benchmark=train_ds.name,
        n_train=len(train_ds),
        n_eval=len(eval_ds),
        final_loss=tlog.losses[-1] if tlog.losses else None,
        train_steps=tlog.steps,
        wall_seconds=round(time.time() - t_start, 2),
    )
    if is_main():
        outputs.write_report(cfg.out_dir, report, name="transfer_report.json")
    return report
