"""The process mesh and its sharding rules.

Counterpart of ``recalgorithm_tpu/parallel/mesh.py``.  The world's ranks form
a (data, model) grid, row-major as the JAX package reshapes its devices: rank
``r`` sits at data row ``r // model`` and model column ``r % model``.

  * ``data`` carries the batch: the ranks of one model column each hold a
    different slice of it, and their replicated parameters' gradients are
    averaged over that column's group (:attr:`ProcessMesh.data_group`);
  * ``model`` carries expert parallelism: the ranks of one data row see the
    same rows and split an expert group's E experts between them
    (:attr:`ProcessMesh.model_group`);
  * embedding tables are row-sharded over every rank: rank ``r`` holds rows
    ``[r V/N, (r+1) V/N)`` (``ROW_ALIGN`` padding makes V divide), and a
    lookup is the explicit exchange of ``embed/sharded.py``;
  * everything else is replicated.

A run of one process has no mesh (``None``) and takes the one-device code
path unchanged.  The rules read the port's ``state_dict`` names; ``convert``
maps them to the flax paths the JAX rules read, so both packages pick the
same parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch.distributed as dist

from recalgorithm_tpu_torch.parallel.multihost import all_gather_rows

DATA_AXIS = "data"
MODEL_AXIS = "model"

# param_specs values: row-sharded over the whole mesh, the expert axis
# sharded over ``model``, or whole on every rank
TABLE = "table"
EXPERT = "expert"
REPLICATED = "replicated"


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in the (data, model) grid and the groups it needs.
    Build it with :func:`make_mesh` on every rank (group creation is
    collective)."""

    rank: int
    world: int
    num_model: int
    data_group: object  # the ranks of this rank's model column
    model_group: object  # the ranks of this rank's data row

    @property
    def data_size(self) -> int:
        return self.world // self.num_model

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.num_model}


def make_mesh(num_model: int = 1) -> ProcessMesh:
    """The (world / num_model, num_model) mesh of the default process group.
    Every rank creates every group, in one order (``new_group`` is
    collective)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_model < 1 or world % num_model:
        raise ValueError(f"{world} ranks not divisible by model={num_model}")
    data = world // num_model
    columns = [dist.new_group([i * num_model + j for i in range(data)])
               for j in range(num_model)]
    rows = [dist.new_group([i * num_model + j for j in range(num_model)])
            for i in range(data)]
    return ProcessMesh(rank=rank, world=world, num_model=num_model,
                       data_group=columns[rank % num_model],
                       model_group=rows[rank // num_model])


def _scopes(name: str) -> list[str]:
    return name.split(".")


def is_embedding_table_path(name: str) -> bool:
    """True for a parameter of an EmbeddingCollection: a scope (any name
    component but the leaf) contains 'embed' (``embedder.embed``,
    FirstOrderLogit's ``embed_w``, W&D's ``wide_embed_w``); a leaf such as
    BST's ``position_embedding`` does not count."""
    return any("embed" in s for s in _scopes(name)[:-1])


def is_expert_param_path(name: str) -> bool:
    """True for a parameter of an ExpertGroup (its module name starts with
    'experts': MMOE's ``experts``, PLE's ``experts_<task>`` /
    ``experts_shared``)."""
    return any(s.startswith("experts") for s in _scopes(name))


def spec_for(name: str, shape: tuple, num_model: int = 1) -> str:
    if is_embedding_table_path(name):
        return TABLE
    # an expert kernel (E, in, H) or bias (E, H) shards its expert axis only
    # when E divides the model axis; otherwise the group stays replicated
    if (is_expert_param_path(name) and len(shape) in (2, 3) and num_model > 0
            and shape[0] % num_model == 0):
        return EXPERT
    return REPLICATED


def param_specs(shapes: Mapping[str, tuple], num_model: int = 1) -> dict[str, str]:
    """``{name: TABLE | EXPERT | REPLICATED}`` for the full (unsharded)
    parameter shapes ``{name: shape}`` (``{n: tuple(p.shape) for n, p in
    model.named_parameters()}``), by the JAX package's name rules: what a
    whole state dict is split by outside a model (:func:`shard_state_dict`).
    A model on a mesh reads :func:`shard_model`'s specs instead."""
    return {name: spec_for(name, tuple(shape), num_model) for name, shape in shapes.items()}


def _sharded(spec: str, mesh: ProcessMesh) -> bool:
    return spec == TABLE or (spec == EXPERT and mesh.num_model > 1)


def shard_tensor(full, spec: str, mesh: ProcessMesh):
    """This rank's part of a whole tensor under ``spec``: a table's rows
    ``[r V/N, (r+1) V/N)``, an expert group's ``[m E/M, (m+1) E/M)``, the
    whole of anything else."""
    if not _sharded(spec, mesh):
        return full
    parts, index = ((mesh.world, mesh.rank) if spec == TABLE
                    else (mesh.num_model, mesh.model_index))
    rows = full.shape[0] // parts
    return full[index * rows:(index + 1) * rows].clone()


def gather_tensor(local, spec: str, mesh: ProcessMesh):
    """The whole tensor from every rank's part (:func:`shard_tensor`
    inverted; collective: every rank calls it, in one order)."""
    if not _sharded(spec, mesh):
        return local
    if spec == TABLE:
        return all_gather_rows(local, None, mesh.world)
    return all_gather_rows(local, mesh.model_group, mesh.num_model)


def shard_state_dict(full: Mapping, specs: Mapping[str, str], mesh: ProcessMesh) -> dict:
    """A whole state dict (``convert.from_flax``, an export) -> this rank's
    shards by ``specs`` (:func:`param_specs`; buffers are replicated)."""
    return {k: shard_tensor(v, specs.get(k, REPLICATED), mesh) for k, v in full.items()}


def gather_state_dict(local: Mapping, specs: Mapping[str, str], mesh: ProcessMesh) -> dict:
    """Every rank's shards -> the whole state dict, on every rank
    (collective)."""
    return {k: gather_tensor(v, specs.get(k, REPLICATED), mesh) for k, v in local.items()}


def shard_model(model, mesh: ProcessMesh) -> dict[str, str]:
    """Put ``model`` on ``mesh``: every module with a ``shard_`` (embedding
    collections, expert groups) keeps its share of its parameters; every
    module with a ``mesh`` attribute (BatchNorm, gates, TwoTower, DIEN) gets
    the mesh for its cross-batch operations.  Returns the spec of every
    entry of the model's ``state_dict`` as the modules' ``shard_`` report
    what they split, REPLICATED for the rest: the one record of what a rank
    holds, which the gradient reduction and the gathers read."""
    specs = {name: REPLICATED for name in model.state_dict()}
    for prefix, m in model.named_modules():
        if hasattr(m, "shard_"):
            for name, spec in m.shard_(mesh).items():
                specs[f"{prefix}.{name}" if prefix else name] = spec
        elif hasattr(m, "mesh"):
            m.mesh = mesh
    return specs
