"""CLI entrypoint: `python -m recalgorithm_tpu_torch.cli.main --model BST --synthetic [flags]`.

Counterpart of ``recalgorithm_tpu/cli/main.py``: the common training flags
keep their names, and every field of the selected model's config dataclass
becomes a flag (comma-separated lists for tuple fields, so
``--hidden_units 512,256,128`` works as in the reference's sweep commands).
``--device`` (default ``cuda``; raises without a GPU) places the run.

Run modes: ``--synthetic`` trains on the WeChat-shaped synthetic stream.  The
TFRecord pipeline (``--train_data``/``--eval_data``/``--vocabulary_dir``) is
not ported yet, nor are ``--stream``, ``--grad_accum_steps``, the mesh flags
and the StableHLO export.

After training: the final eval metrics are printed, and ``predictions.csv``
holds per-task probabilities in the JAX CLI's column layout (reference
wide_and_deep.py:360-375).  A resumed run (a checkpoint in ``--model_dir``)
continues the synthetic stream from the restored step.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys

import torch

from recalgorithm_tpu_torch.cli.serve import add_dataclass_flags

# eval split of the synthetic branch: batches and first seed, as the JAX CLI
EVAL_BATCHES = 16
EVAL_START_SEED = 10_000_000


def build_parser(model_name: str | None = None) -> argparse.ArgumentParser:
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY

    parser = argparse.ArgumentParser(description="recalgorithm_tpu_torch trainer")
    parser.add_argument("--model", default=model_name, required=model_name is None,
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("--model_dir", default="./model_dir")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on WeChat-shaped synthetic data (the only "
                             "data source ported so far)")
    parser.add_argument("--synthetic_vocab_scale", type=float, default=0.01)
    parser.add_argument("--eval_every_steps", type=int, default=0)
    parser.add_argument(
        "--eval_throttle_secs", type=float, default=600.0,
        help="evaluate when this many seconds passed since the last eval "
             "(reference EvalSpec(throttle_secs=600)); 0 disables")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--predictions_csv", default="predictions.csv")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; raises without a "
                             "GPU) or cpu")
    return parser


def main(argv: list[str] | None = None, model_name: str | None = None) -> dict:
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY
    from recalgorithm_tpu_torch.serving.predictor import resolve_device
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig, latest_checkpoint_step

    argv = list(sys.argv[1:] if argv is None else argv)
    pre_args, _ = build_parser(model_name).parse_known_args(argv)
    cfg_cls, model_cls = MODEL_REGISTRY[pre_args.model]
    parser = build_parser(model_name)
    add_dataclass_flags(parser, cfg_cls)
    args = parser.parse_args(argv)
    cfg = cfg_cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cfg_cls)})
    device = resolve_device(args.device)

    if not args.synthetic:
        raise NotImplementedError(
            "the TFRecord pipeline is not ported yet: pass --synthetic")
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(
        seed=args.seed, vocab_scale=args.synthetic_vocab_scale))
    schema = wechat_schema(gen.vocab_sizes())
    start = min(latest_checkpoint_step(args.model_dir), cfg.train_steps)
    train_iter = gen.batches(cfg.batch_size, cfg.train_steps - start, start_seed=start)
    eval_fn = lambda: gen.batches(cfg.batch_size, EVAL_BATCHES, start_seed=EVAL_START_SEED)

    task_names = tuple(cfg.task_names) or (schema.labels[0],)
    model = model_cls(cfg, schema, torch.Generator().manual_seed(args.seed))
    lr = optimizers.make_schedule(cfg.learning_rate, schedule=cfg.lr_schedule,
                                  warmup_steps=cfg.warmup_steps,
                                  decay_steps=cfg.decay_steps)
    trainer = Trainer(
        model, task_names, optimizers.build(cfg.optimizer, lr),
        TrainerConfig(model_dir=args.model_dir, train_steps=cfg.train_steps,
                      log_every=args.log_every, eval_every_steps=args.eval_every_steps,
                      eval_throttle_secs=args.eval_throttle_secs,
                      save_checkpoints_steps=cfg.save_checkpoints_steps, seed=args.seed),
        device=device,
    )
    final_eval = trainer.train_and_evaluate(train_iter, eval_fn)
    for key in sorted(final_eval):
        print(f"{key}: {final_eval[key]}")

    # ---- predictions.csv (reference wide_and_deep.py:370-375): the synthetic
    # branch has no id columns and no labels, as in the JAX CLI
    probs = trainer.predict(eval_fn())
    if os.path.dirname(args.predictions_csv):
        os.makedirs(os.path.dirname(args.predictions_csv), exist_ok=True)
    with open(args.predictions_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([f"{t}_probabilities" for t in task_names])
        for row in zip(*(probs[t] for t in task_names)):
            writer.writerow([f"{p:.6f}" for p in row])
    print(f"wrote {args.predictions_csv}")
    return final_eval


if __name__ == "__main__":
    main()
