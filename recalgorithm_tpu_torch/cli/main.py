"""CLI entrypoint: `python -m recalgorithm_tpu_torch.cli.main --model BST [flags]`.

Counterpart of ``recalgorithm_tpu/cli/main.py``: the common training flags
keep their names, and every field of the selected model's config dataclass
becomes a flag (comma-separated lists for tuple fields, so
``--hidden_units 512,256,128`` works as in the reference's sweep commands).
``--device`` (default ``cuda``; raises without a GPU) places the run.
``--precision bf16`` (a config field) runs the dense towers' and experts'
products in bf16; ``--no_compact_grad_scatter`` turns off the PAD-compacted
table gradient (``ops/compact_scatter.py``), which is on by default as in
the JAX CLI.  ``python -m recalgorithm_tpu_torch.cli.<model>`` (``cli.din``,
``cli.bst``, ...) is this entry point with ``--model`` preset.

Run modes:
  * real data: ``--train_data``/``--eval_data`` point at reference-format
    SequenceExample TFRecords (the output of data/etl.py or data/douban.py),
    ``--vocabulary_dir`` at the ETL's vocabulary txts, ``--dataset`` picks
    the schema; the split is loaded whole through the native reader, or
    streamed in chunks with ``--stream`` (and its on-disk chunk cache);
  * ``--synthetic``: the WeChat-shaped synthetic stream.

After training, ``--export_stablehlo <path>`` writes a serving artifact
(serving/export.py: a ``torch.export`` program, int8 tables with
``--export_quantized``) at ``--serving_batch_size`` rows.  A model class
with a ``wide_param_predicate`` (Wide&Deep) trains with the dual FTRL/deep
optimizer from its config.  ``--eval_recall_at K`` builds, after training,
the item corpus of a retrieval model (one with ``item_embedding``: TwoTower)
from the eval split and reports ``recall_at_K`` with the final eval.

Several processes (``python -m torch.distributed.run --nproc_per_node N -m
recalgorithm_tpu_torch.cli.main ...``, or any launcher that sets torchrun's
environment): the processes form a (N / ``--num_model_shards``,
``--num_model_shards``) mesh (``parallel/mesh.py``) unless ``--no_mesh``;
each reads its data shard's rows (``shard_for_host``, or a strided chunk set
with ``--stream``) in lock-step (``synchronized_iterator``), evaluates its
share of the eval split (padded to a common batch count), and process 0
alone writes ``predictions.csv``, the summaries, Recall@K and the exports.
``--batch_size`` is per process, as in the JAX CLI.  ``--shard_map_embeddings``
is accepted for the JAX CLI's sake: the port's table lookups under a mesh are
always the explicit exchange of ``embed/sharded.py``.

After training: the final eval metrics are printed, and ``predictions.csv``
holds per-task probabilities in the JAX CLI's column layout (reference
wide_and_deep.py:360-375).  On real data the predictions are put back in
file order and joined with the user and item id tokens and the labels, and
the exact AUC and the per-user GAUC are printed beside the binned AUC.  A
resumed run (a checkpoint in ``--model_dir``) continues its seeded batch
stream from the restored step.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import itertools
import os
import sys

import numpy as np
import torch

from recalgorithm_tpu_torch.cli.serve import add_dataclass_flags

# eval split of the synthetic branch: batches and first seed, as the JAX CLI
EVAL_BATCHES = 16
EVAL_START_SEED = 10_000_000


def build_parser(model_name: str | None = None) -> argparse.ArgumentParser:
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY

    parser = argparse.ArgumentParser(description="recalgorithm_tpu_torch trainer")
    parser.add_argument("--model", default=model_name, choices=sorted(MODEL_REGISTRY),
                        help="required unless --list_models")
    parser.add_argument("--list_models", action="store_true",
                        help="print the registered models and exit")
    parser.add_argument("--model_dir", default="./model_dir")
    parser.add_argument("--output_dir", default="./output_dir",
                        help="accepted for the JAX CLI's sake, which reads it nowhere")
    parser.add_argument("--train_data", help="train split TFRecord (required "
                                             "without --synthetic)")
    parser.add_argument("--eval_data", help="eval split TFRecord (required "
                                            "without --synthetic)")
    parser.add_argument("--vocabulary_dir", help="the ETL's vocabulary txts "
                                                 "(required without --synthetic)")
    parser.add_argument("--dataset", default="wechat", choices=("wechat", "douban", "criteo"),
                        help="schema family: 'wechat' (the reference dataset), "
                             "'douban' (data/douban.py's artifacts) or 'criteo' (MLPerf's "
                             "multi-hot Criteo 1TB, on the synthetic stream only)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data shaped as --dataset's schema")
    parser.add_argument("--synthetic_vocab_scale", type=float, default=0.01)
    parser.add_argument("--limit_examples", type=int, default=None,
                        help="cap the examples read from each TFRecord split")
    parser.add_argument("--stream", action="store_true",
                        help="bounded-memory input for both splits: chunked native "
                             "reads, and a shuffle-buffer pool for training")
    parser.add_argument("--stream_chunk_records", type=int, default=65536,
                        help="records per chunked read in --stream mode")
    parser.add_argument("--stream_cache_dir", default=None,
                        help="--stream: spill each chunk's translated arrays here "
                             "on the first pass and serve later passes from disk")
    parser.add_argument("--eval_every_steps", type=int, default=0)
    parser.add_argument(
        "--eval_throttle_secs", type=float, default=600.0,
        help="evaluate when this many seconds passed since the last eval "
             "(reference EvalSpec(throttle_secs=600)); 0 disables")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--grad_accum_steps", type=int, default=1,
                        help="accumulate k micro-batch gradients before each "
                             "optimizer step (effective batch = k x batch_size)")
    parser.add_argument("--num_model_shards", type=int, default=1,
                        help="mesh 'model' axis size (1 = pure data parallel)")
    parser.add_argument("--no_mesh", action="store_true",
                        help="several processes train without a mesh, each alone")
    parser.add_argument("--shard_map_embeddings", action="store_true",
                        help="the explicit embedding exchange (the port's only one "
                             "under a mesh; accepted as the JAX CLI's flag)")
    parser.add_argument("--no_compact_grad_scatter", action="store_true",
                        help="turn off the PAD-compacted gradient of long sequence "
                             "lookups (on by default; a batch that overflows its buffer "
                             "takes the full gradient either way)")
    parser.add_argument("--predictions_csv", default="predictions.csv")
    parser.add_argument("--eval_recall_at", type=int, default=0,
                        help="for retrieval models (TwoTower): after training, "
                        "build the item corpus from the eval split and report "
                        "Recall@K at this K")
    parser.add_argument("--export_stablehlo", default=None,
                        help="after training, write a serving artifact (ids -> "
                             "probabilities; a torch.export program, the JAX CLI's flag "
                             "name) here, with <path>.manifest.json")
    parser.add_argument("--export_quantized", action="store_true",
                        help="int8 embedding tables in the --export_stablehlo artifact")
    parser.add_argument("--serving_batch_size", type=int, default=0,
                        help="batch size baked into the --export_stablehlo artifact "
                             "(0 = the training batch size)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of training here")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default; raises without a "
                             "GPU) or cpu")
    return parser


def list_models() -> None:
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY

    for name in sorted(MODEL_REGISTRY):
        doc = (sys.modules[MODEL_REGISTRY[name][1].__module__].__doc__ or "").strip()
        print(f"{name:20s} {doc.splitlines()[0] if doc else ''}")


def main(argv: list[str] | None = None, model_name: str | None = None) -> dict:
    from recalgorithm_tpu_torch.features.schema import (
        criteo_schema,
        douban_schema,
        wechat_schema,
    )
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY
    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
    from recalgorithm_tpu_torch.parallel import multihost
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig, latest_checkpoint_step
    from recalgorithm_tpu_torch.utils.device import resolve_device
    from recalgorithm_tpu_torch.utils.summary import profile

    argv = list(sys.argv[1:] if argv is None else argv)
    pre_parser = build_parser(model_name)
    pre_args, _ = pre_parser.parse_known_args(argv)
    if pre_args.list_models:
        list_models()
        return {}
    if pre_args.model is None:
        pre_parser.error("--model is required")
    cfg_cls, model_cls = MODEL_REGISTRY[pre_args.model]
    parser = build_parser(model_name)
    add_dataclass_flags(parser, cfg_cls)
    args = parser.parse_args(argv)
    missing = [f"--{k}" for k in ("train_data", "eval_data", "vocabulary_dir")
               if getattr(args, k) is None]
    if not args.synthetic and missing:
        parser.error(f"{', '.join(missing)} required without --synthetic")
    if args.dataset == "criteo" and not args.synthetic:
        parser.error("--dataset criteo runs on the synthetic stream only (--synthetic)")
    cfg = cfg_cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cfg_cls)})
    device = resolve_device(args.device)
    backend = multihost.initialize(device=device)  # no-op for one process
    nproc = multihost.process_count()
    if nproc > 1:
        device = multihost.rank_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    mesh = (mesh_lib.make_mesh(args.num_model_shards)
            if nproc > 1 and not args.no_mesh else None)
    if nproc > 1:
        print(f"process {multihost.process_index()} of {nproc} ({backend}, {device}); "
              + (f"mesh data {mesh.data_size} x model {mesh.num_model}" if mesh else "no mesh"))
    writer = multihost.process_index() == 0
    schema_fn = {"wechat": wechat_schema, "douban": douban_schema,
                 "criteo": criteo_schema}[args.dataset]
    # a resumed run continues the batch stream from the restored step
    start = min(latest_checkpoint_step(args.model_dir), cfg.train_steps)

    # ---- data
    if args.synthetic:
        from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat

        # Criteo's multi-hot bags fill every slot; WeChat's histories vary
        gen = SyntheticWeChat(schema_fn(), SyntheticConfig(
            seed=args.seed, vocab_scale=args.synthetic_vocab_scale,
            full_sequences=args.dataset == "criteo"))
        schema = schema_fn(gen.vocab_sizes())
        train_iter = gen.batches(cfg.batch_size, cfg.train_steps - start, start_seed=start)
        eval_fn = lambda: gen.batches(cfg.batch_size, EVAL_BATCHES, start_seed=EVAL_START_SEED)
        whole_eval_fn = eval_fn
    else:
        from recalgorithm_tpu_torch.data import pipeline
        from recalgorithm_tpu_torch.features.vocab import VocabularyStore

        vocabs = VocabularyStore.from_dir(args.vocabulary_dir)
        schema = schema_fn(vocabs.sizes())
        # this process's data shard (its mesh row); without a mesh every
        # process reads the whole split
        host, hosts = multihost.data_shard(mesh) if mesh is not None else (0, 1)
        if args.stream:
            source = pipeline.stream_batches(
                args.train_data, schema, vocabs, cfg.batch_size, num_epochs=cfg.num_epochs,
                shuffle_buffer_size=cfg.shuffle_buffer_size, seed=args.seed,
                max_steps=cfg.train_steps, chunk_records=args.stream_chunk_records,
                limit=args.limit_examples, host_index=host, host_count=hosts,
                cache_dir=args.stream_cache_dir)

            def eval_fn():
                it = pipeline.stream_eval_batches(
                    args.eval_data, schema, vocabs, cfg.batch_size,
                    chunk_records=args.stream_chunk_records, limit=args.limit_examples,
                    host_index=host, host_count=hosts, cache_dir=args.stream_cache_dir)
                if hosts == 1:
                    return it
                # pad short shards into lock-step: every row scored once
                return multihost.aligned_iterator(
                    it, lambda: pipeline.zero_batch(schema, cfg.batch_size))

            whole_eval_fn = lambda: pipeline.stream_eval_batches(
                args.eval_data, schema, vocabs, cfg.batch_size,
                chunk_records=args.stream_chunk_records, limit=args.limit_examples,
                cache_dir=args.stream_cache_dir)
        else:
            train_arrays = pipeline.load_dataset(args.train_data, schema, vocabs,
                                                 limit=args.limit_examples)
            if hosts > 1:
                train_arrays = pipeline.shard_for_host(train_arrays, mesh)
            source = pipeline.batches(
                train_arrays, cfg.batch_size, num_epochs=cfg.num_epochs,
                shuffle=cfg.shuffle_buffer_size > 0, seed=args.seed,
                drop_remainder=True, max_steps=cfg.train_steps)
            eval_arrays = pipeline.load_dataset(args.eval_data, schema, vocabs,
                                                limit=args.limit_examples)
            whole_eval = eval_arrays
            whole_eval_fn = lambda: pipeline.eval_batches(whole_eval, cfg.batch_size)
            if hosts > 1:
                # every shard steps the batch count of the largest (the last
                # holds the remainder); short ones add zero-weight batches
                n_eval = eval_arrays.num_examples
                first, _ = multihost.host_shard_range(n_eval, mesh)
                eval_arrays = pipeline.shard_for_host(eval_arrays, mesh)
                n_batches = -(-(n_eval // hosts + n_eval % hosts) // cfg.batch_size)
                eval_fn = lambda: pipeline.eval_batches(
                    eval_arrays, cfg.batch_size, num_batches=n_batches, index_offset=first)
            else:
                eval_fn = lambda: pipeline.eval_batches(eval_arrays, cfg.batch_size)
        train_iter = pipeline.prefetch(itertools.islice(source, start, None))
        if mesh is not None:  # outside prefetch: the collective runs on this thread
            train_iter = multihost.synchronized_iterator(train_iter)

    # ---- model + trainer
    task_names = tuple(cfg.task_names) or (schema.labels[0],)
    model = model_cls(cfg, schema, torch.Generator().manual_seed(args.seed))
    # the dual FTRL/deep optimizer for any model class with a wide-parameter
    # split (a class check: WideAndDeepBuiltin registers the same class)
    if hasattr(model_cls, "wide_param_predicate"):
        optimizer = optimizers.dual_wide_deep(
            cfg.wide_part_learning_rate, cfg.deep_part_optimizer, cfg.deep_part_learning_rate,
            model_cls.wide_param_predicate, [n for n, _ in model.named_parameters()])
    else:
        optimizer = optimizers.build(cfg.optimizer, optimizers.make_schedule(
            cfg.learning_rate, schedule=cfg.lr_schedule, warmup_steps=cfg.warmup_steps,
            decay_steps=cfg.decay_steps), **cfg.optimizer_options())
    trainer = Trainer(
        model, task_names, optimizer,
        TrainerConfig(model_dir=args.model_dir, train_steps=cfg.train_steps,
                      log_every=args.log_every, eval_every_steps=args.eval_every_steps,
                      eval_throttle_secs=args.eval_throttle_secs,
                      save_checkpoints_steps=cfg.save_checkpoints_steps, seed=args.seed,
                      compact_grad_scatter=not args.no_compact_grad_scatter,
                      grad_accum_steps=args.grad_accum_steps),
        device=device, mesh=mesh,
        global_batch_size=cfg.batch_size * mesh.data_size if mesh is not None else None,
    )
    with profile(args.profile_dir or "", enabled=args.profile_dir is not None):
        final_eval = trainer.train_and_evaluate(train_iter, eval_fn)
    for key in sorted(final_eval):
        print(f"{key}: {final_eval[key]}")

    # the whole model for Recall@K and the artifact, gathered once (every
    # process enters the gather; process 0 uses it)
    whole = trainer.model
    want_recall = args.eval_recall_at and hasattr(trainer.model, "item_embedding")
    if mesh is not None and (want_recall or args.export_stablehlo):
        state = trainer.full_state_dict()
        whole = model_cls(cfg, schema)
        whole.load_state_dict(state)
        whole.to(device)

    # ---- retrieval quality (TwoTower): offline Recall@K over the eval split
    if want_recall and writer:
        from recalgorithm_tpu_torch.serving.retrieval import Retriever

        retr = Retriever(whole, device)  # over the whole eval split
        n_corpus = retr.build_corpus(whole_eval_fn())
        k = args.eval_recall_at
        final_eval[f"recall_at_{k}"] = retr.recall_at_k(whole_eval_fn(), k=k)
        print(f"recall_at_{k}: {final_eval[f'recall_at_{k}']:.4f} (corpus {n_corpus}, "
              f"random ~{min(k / n_corpus, 1.0):.4f})")

    # ---- predictions.csv (reference wide_and_deep.py:370-375)
    eval_ids: dict[str, np.ndarray] = {}
    eval_labels = None
    if args.synthetic:  # no id columns and no labels, as in the JAX CLI
        probs = trainer.predict(eval_fn())
    else:
        # the first two categorical fields are the user and item ids of
        # every schema (userid/feedid, USER_MD5/MOVIE_ID); their tokens come
        # from the inverse vocabulary, so predictions.csv joins with the raw
        # test split (the reference joins with its test CSV)
        id_cols = list(schema.categorical_names[:2])
        probs, collected = trainer.predict(eval_fn(), collect=("labels", "_index", *id_cols))
        order = np.argsort(collected["_index"], kind="stable")
        probs = {t: v[order] for t, v in probs.items()}
        collected = {k: v[order] for k, v in collected.items()}
        idx = collected["_index"]
        if len(idx) != len(np.unique(idx)):
            raise RuntimeError("duplicate eval rows in predictions")
        if args.limit_examples is None and not np.array_equal(idx, np.arange(len(idx))):
            raise RuntimeError("eval row ids are not contiguous from 0: some example "
                               "was never scored")
        eval_labels = collected["labels"]
        for k in id_cols:
            toks = np.asarray([""] + vocabs[schema.vocab_of(k)].tokens(), dtype=object)
            eval_ids[k] = toks[collected[k]]
        _exact_metrics(final_eval, schema, task_names, probs, eval_labels,
                       collected[id_cols[0]])

    if not writer:  # every process holds the same global rows; process 0 writes
        return final_eval
    if os.path.dirname(args.predictions_csv):
        os.makedirs(os.path.dirname(args.predictions_csv), exist_ok=True)
    with open(args.predictions_csv, "w", newline="") as f:
        writer = csv.writer(f)
        id_cols = sorted(eval_ids)
        header = id_cols + [f"{t}_probabilities" for t in task_names]
        if eval_labels is not None:
            header += list(schema.labels)
        writer.writerow(header)
        n = len(probs[task_names[0]])
        for i in range(n):
            row = [str(eval_ids[c][i]) for c in id_cols]
            row += [f"{probs[t][i]:.6f}" for t in task_names]
            if eval_labels is not None:
                row += [f"{v:g}" for v in eval_labels[i]]
            writer.writerow(row)
    print(f"wrote {args.predictions_csv}")

    # ---- the serving artifact (the reference exports a SavedModel at the end
    # of every run)
    if args.export_stablehlo:
        from recalgorithm_tpu_torch.serving.export import export_stablehlo

        export_stablehlo(whole, schema, args.serving_batch_size or cfg.batch_size,
                         args.export_stablehlo, quantize_embeddings=args.export_quantized)
        print(f"wrote {args.export_stablehlo} ({os.path.getsize(args.export_stablehlo)} "
              f"bytes, quantized={args.export_quantized})")
    return final_eval


def _exact_metrics(final_eval: dict, schema, task_names, probs, labels, users) -> None:
    """The unbinned rank AUC (the ground truth the 200-bin streaming AUC
    approximates) and the per-user GAUC of each task with a label column,
    printed and added to ``final_eval``.  Id 0 (OOV users, all translated
    to one id) is left out of GAUC, where it would pool unrelated users."""
    from recalgorithm_tpu_torch.train.metrics import exact_auc, grouped_auc

    label_idx = {name: i for i, name in enumerate(schema.labels)}
    known = users > 0
    for t in task_names:
        if t not in label_idx:
            continue
        y = labels[:, label_idx[t]]
        final_eval[f"{t}_exact_auc"] = exact_auc(y, probs[t])
        final_eval[f"{t}_gauc"] = grouped_auc(y[known], probs[t][known], users[known])
        print(f"{t}_exact_auc: {final_eval[f'{t}_exact_auc']}")
        print(f"{t}_gauc: {final_eval[f'{t}_gauc']}")


if __name__ == "__main__":
    from recalgorithm_tpu_torch.parallel import multihost

    try:
        main()
    finally:
        multihost.shutdown()
