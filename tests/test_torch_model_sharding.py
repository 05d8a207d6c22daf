"""The port's partition specs (`repro_torch.models.sharding`,
`repro_torch.launch.specs`) against the reference's, entry by entry.

For each of the ten families at its full published config, on the
production mesh (16, 16) and the multi-pod mesh (2, 16, 16), with
`REPRO_NO_FSDP` unset and set to 1: the port's
`param_specs(params_struct(cfg))` equals the reference's
`param_specs(jax.eval_shape(init_params, ...))`; likewise `cache_spec`
over each `shapes_for` shape's decode cache, and `batch_spec`.

The reference's rules read only `ctx.mesh.shape`, so a stand-in mesh
serves it (no 256-device XLA).  The port's rules run on its real
production meshes, over a fake world of 256 or 512 ranks in this
process (nothing is allocated).
"""
import functools
import types

import jax
import pytest
import torch

import repro.configs as RC
import repro.launch.specs as RSP
import repro.models.sharding as RS
import repro_torch.launch.mesh as PMESH
import repro_torch.launch.specs as PSP
import repro_torch.models.sharding as PS
from repro.models.config import SHAPES
from repro_torch.models.tree import leaves

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def ref_ctx(mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    dp = ("pod", "data") if "pod" in axes else ("data",)
    return RS.Ctx(mesh=mesh, dp_axes=dp, tp_axis="model")


@pytest.fixture
def port_ctx(request):
    """The port's production mesh of the test's `mesh_name`, in a fake
    world open for the test."""
    multi = request.getfixturevalue("mesh_name") == "multipod"
    with PMESH.world(512 if multi else 256, "fake"):
        yield PMESH.make_ctx(PMESH.make_production_mesh(multi_pod=multi))


@functools.lru_cache(maxsize=None)
def ref_struct(arch):
    return RSP.params_struct(RC.get_config(arch))


def ref_leaves(tree):
    """(key path, spec as a tuple) of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jax.tree_util.keystr(k), tuple(v)) for k, v in flat]


def port_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in port_leaves(tree[k], f"{path}['{k}']")]
    if isinstance(tree, tuple) and not isinstance(tree, PS.P):
        return [x for i, v in enumerate(tree)
                for x in port_leaves(v, f"{path}[{i}]")]
    return [(path, tuple(tree))]


@pytest.mark.parametrize("no_fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_param_specs_equal_reference(arch, mesh_name, no_fsdp, port_ctx,
                                     monkeypatch):
    if no_fsdp:
        monkeypatch.setenv("REPRO_NO_FSDP", "1")
    else:
        monkeypatch.delenv("REPRO_NO_FSDP", raising=False)
    want = ref_leaves(RS.param_specs(ref_struct(arch), ref_ctx(mesh_name)))
    struct = PSP.params_struct(PSP.cell(arch, "train_4k")[0])
    got = port_leaves(PS.param_specs(struct, port_ctx))
    assert got == want
    # the placements are the specs': one a mesh dimension
    pl = PSP.param_shardings(struct, port_ctx)
    for (_, spec), p in zip(got, port_leaves_pl(pl)):
        assert p == PS.placements(PS.P(*spec), port_ctx.mesh)


def port_leaves_pl(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in port_leaves_pl(tree[k])]
    if isinstance(tree, tuple) and tree and isinstance(tree[0],
                                                       (tuple, dict)):
        return [x for v in tree for x in port_leaves_pl(v)]
    return [tree]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_cache_and_batch_specs_equal_reference(arch, mesh_name, port_ctx):
    rctx = ref_ctx(mesh_name)
    assert PS.batch_spec(port_ctx) == RS.batch_spec(rctx)
    cfg = PSP.cell(arch, "train_4k")[0]
    rcfg = RC.get_config(arch)
    for shape_name in RC.shapes_for(arch):
        shape = SHAPES[shape_name]
        b = shape.global_batch
        batch = PSP.batch_struct(cfg, shape, train=shape.kind == "train")
        rbatch = RSP.batch_struct(rcfg, shape, train=shape.kind == "train")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in batch.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in rbatch.items()}
        for k, spec in PSP.batch_specs(batch, port_ctx).items():
            assert tuple(spec) == (RS.batch_spec(rctx),) \
                + (None,) * (batch[k].ndim - 1)
        if shape.kind != "decode":
            continue
        _, _, cache = PSP.decode_structs(cfg, shape)
        _, _, rcache = RSP.decode_structs(rcfg, shape)
        got = [(tuple(x.shape), tuple(PS.cache_spec(tuple(x.shape), b,
                                                    port_ctx)))
               for c in cache for k in sorted(c) for x in [c[k]]]
        want = [(tuple(x.shape), tuple(RS.cache_spec(x.shape, b, rctx)))
                for x in jax.tree.leaves(rcache)]
        assert got == want, shape_name
        assert [tuple(s) for c in PSP.cache_specs(cache, b, port_ctx)
                for k in sorted(c) for s in [c[k]]] == [w for _, w in want]


def test_specs_without_a_mesh_are_empty():
    ctx = PS.Ctx()
    assert ctx.dp_size == 1 and ctx.tp_size == 1
    assert PS.leaf_spec((64, 64), ctx, stacked=False) == PS.P()
    assert PS.cache_spec((2, 4, 8, 2, 16), 4, ctx) == PS.P()
    assert PS.shardings_for({"w": torch.zeros(2)}, ctx) is None
    x = torch.ones(3)
    assert ctx.constraint(x, PS.P("data")) is x


def test_params_struct_allocates_nothing():
    """DeepSeek-V2-236B's tree on the meta device: every leaf has the
    reference's shape and dtype, and no byte is allocated."""
    cfg = PSP.cell("deepseek_v2_236b", "train_4k")[0]
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
           for t in leaves(PSP.params_struct(cfg))]
    want = [(tuple(x.shape), str(x.dtype), "meta")
            for x in jax.tree.leaves(ref_struct("deepseek_v2_236b"))]
    assert got == want


def test_production_mesh_wants_its_ranks():
    with PMESH.world(8, "fake"):
        with pytest.raises(RuntimeError, match="need 256 devices, have 8"):
            PMESH.make_production_mesh()


def test_a_world_left_open_does_not_break_the_next():
    import torch.distributed as dist

    PMESH._register_fake()
    dist.init_process_group("fake", rank=0, world_size=4,
                            store=PMESH._Store())
    with PMESH.world(256, "fake"):
        mesh = PMESH.make_production_mesh()
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
