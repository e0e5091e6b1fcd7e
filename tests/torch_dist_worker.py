"""One rank of the port's several-process CPU tests.

    python tests/torch_dist_worker.py <scenario> <rank> <world> <store> <in_dir> <out_dir>

Started by ``tests/torch_dist_common.run_world``: each rank joins a gloo
process group through the ``file://`` store (no TCP port, so parallel test
workers never race for one), runs on one CPU thread, reads its inputs from
``in_dir`` (weights and global batches the test wrote from the JAX package)
and writes ``<name>.r<rank>.npz`` results to ``out_dir``.  Imports the port
only, never JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


def _save(out_dir: str, name: str, rank: int, **arrays) -> None:
    np.savez(os.path.join(out_dir, f"{name}.r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def _batch(z, i: int, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of global batch ``i`` of an npz written by the test."""
    prefix = f"b{i}/"
    return {k[len(prefix):]: z[k][lo:hi] for k in z.files if k.startswith(prefix)}


def _trainer(tag: str, in_dir: str, model_dir: str, mesh, global_rows: int, optimizer, lr,
             model=None, **cfg_kw):
    """The port's ``model`` (default ``tag``) from the whole JAX weights in
    ``in_dir/tag``, sharded onto ``mesh`` by its Trainer, whose train steps
    take ``global_rows`` rows over all ranks."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    with open(os.path.join(in_dir, "vocab_sizes.json")) as f:
        schema = wechat_schema(json.load(f))
    cfg_cls, cls = get_model(model or tag)
    cfg = cfg_cls(**cfg_kw)
    model = cls(cfg, schema)
    model.load_state_dict(convert.load_export(os.path.join(in_dir, tag)))
    return Trainer(model, tuple(cfg.task_names) or (schema.labels[0],),
                   optimizers.build(optimizer, lr),
                   TrainerConfig(model_dir=model_dir, save_checkpoints_steps=0),
                   device="cpu", mesh=mesh, global_batch_size=global_rows)


def _train(tag: str, rank: int, in_dir: str, out_dir: str, mesh, steps: int,
           optimizer: str, lr: float, **kw):
    """``steps`` train steps of ``tag`` (``_trainer``) on this rank's rows of
    the test's global batches ``<tag>_batches.npz``; saves the global
    losses, the whole state after the steps and this rank's parameters, and
    returns the trainer."""
    from recalgorithm_tpu_torch.parallel import multihost

    z = np.load(os.path.join(in_dir, f"{tag}_batches.npz"))
    tr = _trainer(tag, in_dir, os.path.join(out_dir, f"{tag}_r{rank}"), mesh,
                  len(z["b0/labels"]), optimizer, lr, **kw)
    losses = []
    for i in range(steps):
        rows = len(z[f"b{i}/labels"])
        lo, hi = multihost.host_shard_range(rows, mesh)
        losses.append(float(tr.train_step(_batch(z, i, lo, hi))))
    state = tr.full_state_dict()
    _save(out_dir, tag, rank, losses=losses,
          **{f"state/{k}": v.detach().numpy() for k, v in state.items()},
          **{f"local/{k}": p.detach().numpy() for k, p in tr.model.named_parameters()})
    return tr


def lookup(rank: int, world: int, in_dir: str, out_dir: str, device: str = "cpu") -> None:
    """sharded_lookup on every mesh of this world, on ``device``: forward and
    the table gradient of sum(out^2) (gathered whole), repeated ids, ids
    whose count does not divide the model axis, and the shape checks."""
    from recalgorithm_tpu_torch.embed.sharded import sharded_lookup
    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
    from recalgorithm_tpu_torch.parallel import multihost

    z = np.load(os.path.join(in_dir, "lookup.npz"))
    table, rows = torch.from_numpy(z["table"]).to(device), z["table"].shape[0]
    for num_model in (1, 2) if world > 2 else (1,):
        mesh = mesh_lib.make_mesh(num_model)
        out = {}
        # "odd": data row d looks up row d of ids_odd, 7 ids, which a model
        # axis of 2 does not divide
        odd = z["ids_odd"][:mesh.data_size]
        for case, ids_all in (("plain", z["ids"]), ("dup", np.full_like(z["ids"], 7)),
                              ("odd", odd.reshape(-1))):
            lo, hi = multihost.host_shard_range(len(ids_all), mesh)
            shard = mesh_lib.shard_tensor(table, mesh_lib.TABLE, mesh).requires_grad_()
            emb = sharded_lookup(shard, torch.from_numpy(ids_all[lo:hi]).to(device), mesh, rows)
            (emb * emb if case != "dup" else emb).sum().backward()
            out[f"{case}/forward"] = multihost.all_gather_rows(
                emb.detach().reshape(-1, table.shape[1]), mesh.data_group, mesh.data_size)
            out[f"{case}/grad"] = mesh_lib.gather_tensor(shard.grad, mesh_lib.TABLE, mesh)
        shard = mesh_lib.shard_tensor(table, mesh_lib.TABLE, mesh)
        errors = []
        zeros = torch.zeros(4, dtype=torch.long, device=device)
        for bad in (lambda: sharded_lookup(shard[:3], zeros, mesh, rows),
                    lambda: sharded_lookup(shard, zeros, mesh, rows + 1),
                    lambda: sharded_lookup(shard, zeros.float(), mesh, rows)):
            try:
                bad()
                errors.append("")
            except ValueError as exc:
                errors.append(str(exc))
        # an EmbeddingCollection's rules under the mesh: the clip rule, the
        # dense rule, and the int8 rule of a table quantized, then sharded
        from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
        from recalgorithm_tpu_torch.serving.quantize import quantize_table

        def collection():
            return EmbeddingCollection({"big": TableSpec("big", 3000, 8),
                                        "small": TableSpec("small", 100, 4)},
                                       torch.Generator().manual_seed(0))

        ids = z["rule_ids"]
        lo, hi = multihost.host_shard_range(len(ids), mesh)
        local = torch.from_numpy(ids[lo:hi]).to(device)
        coll, quant = collection(), collection()
        q, scale = quantize_table(quant.tables["big"].detach().numpy())
        quant.quantize_("big", torch.from_numpy(q), torch.from_numpy(scale))
        for c in (coll, quant):
            c.shard_(mesh)
            c.to(device)
        with torch.no_grad():
            rules = {"clip": coll.embed_scalar("big", local),
                     "dense": coll.embed_scalar("small", local),
                     "int8": quant.embed_scalar("big", local)}
        for rule, emb in rules.items():
            out[f"rule_{rule}"] = multihost.all_gather_rows(emb.detach(), mesh.data_group,
                                                            mesh.data_size)
        _save(out_dir, f"lookup_m{num_model}", rank, errors=errors,
              **{k: v.cpu() for k, v in out.items()})


def top_k(rank: int, world: int, in_dir: str, out_dir: str) -> None:
    """sharded_top_k on the test's cases, over all ranks."""
    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
    from recalgorithm_tpu_torch.serving.retrieval import sharded_top_k

    z = np.load(os.path.join(in_dir, "top_k.npz"))
    mesh = mesh_lib.make_mesh(1)
    out = {}
    for case in sorted({k.split("/")[0] for k in z.files}):
        k = int(z[f"{case}/k"])
        s, i = sharded_top_k(torch.from_numpy(z[f"{case}/u"]), torch.from_numpy(z[f"{case}/c"]),
                             k, mesh)
        out[f"{case}/scores"], out[f"{case}/indices"] = s, i
    _save(out_dir, "top_k", rank, **out)


def distributed(rank: int, world: int, in_dir: str, out_dir: str) -> None:
    """The trainer's several-process paths against the test's JAX runs
    (``runs.json``: each model's steps on a data-parallel or a (1, 2) mesh),
    then with DeepCrossing's trainer the best-export gather with a full best
    list and a checkpoint round trip; then sharded_top_k."""
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
    from recalgorithm_tpu_torch.train.loop import _Checkpointer

    data_mesh = mesh_lib.make_mesh(1)
    meshes = {1: data_mesh, 2: mesh_lib.make_mesh(2)}
    with open(os.path.join(in_dir, "runs.json")) as f:
        runs = json.load(f)  # tag -> model, overrides, optimizer, rate, steps, model axis
    for r in runs.values():  # JSON lists back to the configs' tuples
        r["kw"] = {k: tuple(v) if isinstance(v, list) else v for k, v in r["kw"].items()}
    trainers = {tag: _train(tag, rank, in_dir, out_dir, meshes[r["model_axis"]], r["steps"],
                            r["optimizer"], r["lr"], model=r["model"], **r["kw"])
                for tag, r in runs.items()}
    tr, dc = trainers["DeepCrossing"], runs["DeepCrossing"]

    # best exports with a full list (keep 1): better, worse (every rank
    # skips the gather), better again (every rank gathers, the old one goes)
    export_root = os.path.join(out_dir, "exports")
    ck = _Checkpointer(export_root, keep_best=1)
    steps = []
    for auc in (0.9, 0.5, 0.95):
        tr.step += 1
        ck.maybe_export_best(tr, auc)
        steps.append(tr.step)
    whole = tr.full_state_dict()
    # a checkpoint round trip: gathered to rank 0's one file, restored as shards
    ck.save(tr)
    again = _trainer("DeepCrossing", in_dir, export_root, data_mesh, tr.global_batch_size,
                     dc["optimizer"], dc["lr"], model=dc["model"], **dc["kw"])
    _Checkpointer(export_root).restore_latest(again)
    same_params = all(torch.equal(a, b) for a, b in zip(tr.model.parameters(),
                                                       again.model.parameters()))
    sa, sb = tr.optimizer.state_dict(), again.optimizer.state_dict()
    same_opt = all(torch.equal(sa["opt"]["state"][i][key], sb["opt"]["state"][i][key])
                   for i in sa["opt"]["state"] for key in ("exp_avg", "exp_avg_sq"))
    exported = {}
    if rank == 0:
        exported = convert.load_export(os.path.join(export_root, "export", f"best_{steps[-1]}"))
    _save(out_dir, "export", rank, steps=steps, same_params=same_params, same_opt=same_opt,
          restored_step=again.step, listed=json.dumps(convert.read_best(export_root)),
          dirs=json.dumps(sorted(os.listdir(os.path.join(export_root, "export")))),
          **{f"whole/{k}": v.numpy() for k, v in whole.items()},
          **{f"exported/{k}": v.numpy() for k, v in exported.items()})
    top_k(rank, world, in_dir, out_dir)


def _cli(mode: str, rank: int, in_dir: str, out_dir: str) -> None:
    """cli.main on the test's TFRecord split (tests/test_multihost_cli.py's
    flags), whole-load or ``--stream``; saves its final eval."""
    from recalgorithm_tpu_torch.cli.main import main as cli_main

    flags = ["--model", "DeepCrossing",
             "--train_data", os.path.join(in_dir, "train.tfrecord"),
             "--eval_data", os.path.join(in_dir, "eval.tfrecord"),
             "--vocabulary_dir", os.path.join(in_dir, "vocabulary"),
             "--model_dir", os.path.join(out_dir, "model"),
             "--predictions_csv", os.path.join(out_dir, "predictions.csv"),
             "--train_steps", "4", "--batch_size", "16", "--residual_internal_dim", "8",
             "--save_checkpoints_steps", "0", "--eval_throttle_secs", "0", "--seed", "11",
             "--device", "cpu"]
    if mode == "stream":
        flags += ["--stream", "--stream_chunk_records", "16", "--shuffle_buffer_size", "32"]
    with open(os.path.join(out_dir, f"final.r{rank}.json"), "w") as f:
        json.dump(cli_main(flags), f)


def compact_no_mesh(rank: int, world: int, in_dir: str, out_dir: str) -> None:
    """``--no_mesh`` with the PAD-compacted table gradient: each rank trains
    DIN alone (no mesh, its own batches ``DIN_r<rank>_batches.npz``), with
    ``MIN_IDS`` 0 so that these small batches may compact, deciding per
    batch on its own; saves its losses, its decisions and its parameters."""
    import torch.distributed as dist

    from recalgorithm_tpu_torch.ops import compact_scatter as cs

    cs.MIN_IDS = 0
    z = np.load(os.path.join(in_dir, f"DIN_r{rank}_batches.npz"))
    tr = _trainer("DIN", in_dir, os.path.join(out_dir, f"DIN_r{rank}"), None, None, "sgd",
                  0.01, hidden_units=(16, 8), dropout_rate=0.0)
    n = len({k.split("/")[0] for k in z.files})
    batches = [_batch(z, i, 0, len(z[f"b{i}/labels"])) for i in range(n)]
    fits = [cs.batch_fits_compact(hb, tr.model.schema) for hb in batches]
    losses = [float(tr.train_step(hb)) for hb in batches]
    dist.barrier()  # the world is live; no step entered a collective
    _save(out_dir, "DIN", rank, losses=losses, fits=fits,
          **{f"param/{k}": p.detach().numpy() for k, p in tr.model.named_parameters()})


SCENARIOS = {"lookup": lookup, "compact_no_mesh": compact_no_mesh, "top_k": top_k, "distributed": distributed,
             # two ranks sharing one card over gloo, CUDA tensors
             "lookup_cuda": lambda rank, world, i, o: lookup(rank, world, i, o, "cuda"),
             "cli_whole": lambda rank, world, i, o: _cli("whole", rank, i, o),
             "cli_stream": lambda rank, world, i, o: _cli("stream", rank, i, o)}


def main() -> None:
    scenario, rank, world, store, in_dir, out_dir = sys.argv[1:7]
    torch.set_num_threads(1)
    from recalgorithm_tpu_torch.parallel import multihost

    device = "cuda" if scenario.endswith("_cuda") else "cpu"
    multihost.initialize(f"file://{store}", int(world), int(rank), device=device)
    try:
        SCENARIOS[scenario](int(rank), int(world), in_dir, out_dir)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
