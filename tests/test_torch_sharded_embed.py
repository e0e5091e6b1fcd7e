"""Port parity for ``embed/sharded.py``: the cases of tests/test_sharded_embed.py
on 2- and 4-rank gloo worlds on the CPU (a (2, 1), a (4, 1) and a mixed
(2, 2) data x model mesh): the forward equals the plain gather, the backward
the scatter-add (repeated ids accumulate), the shape checks raise, and both
are held against JAX's ``sharded_lookup`` on the 8-device CPU mesh for the
same table and ids; ids whose count does not divide the model axis are
padded and give the plain gather too.  ``embed/tables.py`` under a mesh
keeps the one-process rules (clip, dense and int8).

Tolerances: the forward is a gather and a sum with one non-zero term a row,
exact; gradients sum the same terms in another order, rtol 1e-6 and atol
1e-6 (f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recalgorithm_tpu.embed.sharded import sharded_lookup as jax_sharded_lookup
from recalgorithm_tpu.parallel import mesh as jax_mesh
from recalgorithm_tpu_torch.embed.sharded import plain_lookup
from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
from recalgorithm_tpu_torch.serving.quantize import quantize_table

from torch_dist_common import result, run_world

ROWS, DIM, N_IDS = 256, 16, 64
GRAD = dict(rtol=1e-6, atol=1e-6)
MESHES = {2: (1,), 4: (1, 2)}  # world -> model axis sizes run in it


def _inputs():
    rng = np.random.default_rng(0)
    return {"table": rng.normal(size=(ROWS, DIM)).astype(np.float32),
            "ids": rng.integers(0, ROWS, size=(N_IDS,)).astype(np.int32),
            # a data row d of a mesh looks up row d: 7 ids, which a model
            # axis of 2 does not divide
            "ids_odd": rng.integers(0, ROWS, size=(4, 7)).astype(np.int32),
            # EmbeddingCollection's rules: PAD, valid, past the vocabulary
            # (the clip rule's padding rows), negative
            "rule_ids": np.concatenate([[0, 1, 2999, 3000, 3071, 5000, -3, 99, 100, 101],
                                        rng.integers(0, 3000, 54)]).astype(np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_embed")
    np.savez(tmp / "lookup.npz", **_inputs())
    return {world: run_world(tmp, "lookup", world, tmp) for world in MESHES}


def _cases():
    return [(w, m) for w, ms in MESHES.items() for m in ms]


def _plain(table, ids, case):
    """numpy forward and table gradient of the case's loss."""
    out = table[ids]
    g = np.zeros_like(table)
    np.add.at(g, ids, np.ones_like(out) if case == "dup" else 2 * out)
    return out, g


def _ids(z, world, num_model):
    return (("plain", z["ids"]), ("odd", z["ids_odd"][:world // num_model].reshape(-1)))


@pytest.mark.parametrize("world,num_model", _cases())
def test_forward_matches_plain_gather(runs, world, num_model):
    z, r = _inputs(), result(runs[world], f"lookup_m{num_model}")
    for case, ids in _ids(z, world, num_model):
        np.testing.assert_array_equal(r[f"{case}/forward"], z["table"][ids], err_msg=case)


@pytest.mark.parametrize("world,num_model", _cases())
def test_backward_is_scatter_add(runs, world, num_model):
    z, r = _inputs(), result(runs[world], f"lookup_m{num_model}")
    for case, ids in _ids(z, world, num_model):
        np.testing.assert_allclose(r[f"{case}/grad"], _plain(z["table"], ids, case)[1], **GRAD,
                                   err_msg=case)
    # duplicate ids accumulate (scatter-ADD, not overwrite)
    np.testing.assert_allclose(r["dup/grad"][7], float(N_IDS), rtol=1e-6)
    np.testing.assert_array_equal(r["dup/grad"][8], 0.0)


@pytest.mark.parametrize("world,num_model", _cases())
def test_every_rank_holds_the_same_result(runs, world, num_model):
    first = result(runs[world], f"lookup_m{num_model}", 0)
    for rank in range(1, world):
        other = result(runs[world], f"lookup_m{num_model}", rank)
        for k in ("plain/forward", "plain/grad", "odd/grad"):
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("world,num_model", _cases())
def test_shape_validation(runs, world, num_model):
    errors = result(runs[world], f"lookup_m{num_model}")["errors"]
    assert "(64, K)" in errors[0] or "K), got" in errors[0], errors[0]
    assert "not divisible" in errors[1], errors[1]
    assert "integers" in errors[2], errors[2]


@pytest.mark.parametrize("num_model", (1, 2))
def test_matches_jax_sharded_lookup(runs, num_model):
    """The port's 4-rank exchange against JAX's shard_map exchange on the
    8-device mesh (data x model = 8/num_model x num_model): forward and
    gradient of sum(out^2), the mixed mesh included."""
    z = _inputs()
    mesh = jax_mesh.make_mesh(num_model=num_model)
    table = jax.device_put(jnp.asarray(z["table"]), NamedSharding(mesh, jax_mesh.TABLE_SPEC))
    ids = jax.device_put(jnp.asarray(z["ids"]), NamedSharding(mesh, P("data")))

    def loss(t):
        out = jax_sharded_lookup(t, ids, mesh)
        return jnp.sum(out * out), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(table)
    r = result(runs[4], f"lookup_m{num_model}")
    np.testing.assert_array_equal(r["plain/forward"], np.asarray(jout))
    np.testing.assert_allclose(r["plain/grad"], np.asarray(jgrad), **GRAD)


@pytest.mark.parametrize("world,num_model", _cases())
def test_collection_rules_under_the_mesh(runs, world, num_model):
    """A sharded EmbeddingCollection keeps the one-process rules: the clip
    rule (ids past the vocabulary read the padding rows), the dense rule
    and the int8 rule of a table quantized before it was sharded."""
    ids = torch.from_numpy(_inputs()["rule_ids"])

    def collection():
        return EmbeddingCollection({"big": TableSpec("big", 3000, 8),
                                    "small": TableSpec("small", 100, 4)},
                                   torch.Generator().manual_seed(0))

    coll, quant = collection(), collection()
    q, scale = quantize_table(quant.tables["big"].detach().numpy())
    quant.quantize_("big", torch.from_numpy(q), torch.from_numpy(scale))
    with torch.no_grad():
        want = {"clip": coll.embed_scalar("big", ids), "dense": coll.embed_scalar("small", ids),
                "int8": quant.embed_scalar("big", ids)}
    r = result(runs[world], f"lookup_m{num_model}")
    for rule, w in want.items():
        np.testing.assert_array_equal(r[f"rule_{rule}"], w.numpy(), err_msg=rule)


def test_plain_lookup_zero_rows_out_of_range():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = plain_lookup(table, torch.tensor([[0, 3], [-1, 4]]))
    np.testing.assert_array_equal(out.numpy(), [[[0, 1, 2], [9, 10, 11]],
                                                [[0, 0, 0], [0, 0, 0]]])


def test_one_process_tables_have_no_mesh():
    """Without shard_ the collection keeps whole tables and the one-process
    gather: the mesh path is reached only through the trainer's sharding."""
    coll = EmbeddingCollection({"t": TableSpec("t", 300, 4)}, torch.Generator().manual_seed(0))
    assert coll.mesh is None and coll.tables["t"].shape == (512, 4)
    ids = torch.tensor([0, 5, 299, 511, 600])
    np.testing.assert_array_equal(coll.embed_sequence("t", ids[None])[0].detach().numpy(),
                                  (coll.tables["t"][ids.clamp(max=511)]
                                   * (ids > 0)[:, None]).detach().numpy())
