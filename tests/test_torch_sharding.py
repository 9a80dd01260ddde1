"""The port's sharding rules against the JAX package's, in one process.

JAX's rules run on ``jax.sharding.AbstractMesh`` over ``jax.eval_shape``
trees; the port's on ``launch.mesh.MeshShape`` over the same shapes in the
port's layout (each layer stack a list of per-layer meta tensors), and on a
``Transformer`` of a reduced config.  Every spec must be equal, leaf for
leaf, after the port's per-layer spec is given back its stack entry
(``None``): every config, the meshes (16, 16), (2, 16, 16), (2, 4), (4, 2)
and (2, 2), ``fsdp`` on and off, layouts "2d" and "dp_only".
``train_state_shardings(zero1=True)`` is the one departure: JAX's raises
``DuplicateSpecError``, the port's adds the data axes only where a moment
does not carry them yet.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.distributed import layout as jlayout
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.convert import _split_layers
from repro_torch.distributed import layout as tlayout
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttr
from repro_torch.optim import Int8ErrorFeedback, init_adamw_state

ARCHS = sorted(treg.ARCHITECTURES)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}


def _meshes():
    for shape, axes in MESHES.values():
        yield AbstractMesh(shape, axes), tmesh.MeshShape(shape, axes)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    """JAX's parameter shapes, and the same shapes in the port's layout."""
    jcfg = jreg.get_config(arch)
    shapes = jax.eval_shape(lambda: jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    return shapes, _split_layers(treg.get_config(arch), meta, lambda t: t)


def _jax_specs(shardings, shapes):
    """JAX's specs as the port's ``PartitionSpec``s, padded to each leaf's rank."""
    return jax.tree_util.tree_map(
        lambda sh, s: P(*(tuple(sh.spec) + (None,) * (len(s.shape) - len(sh.spec)))),
        shardings, shapes)


def _restack(tree):
    """The port's specs in JAX's layout: each layer stack's per-layer specs
    (which must agree) as one spec with the stack entry first."""
    if isinstance(tree, dict):
        return {k: _restack(v) for k, v in tree.items()}
    if isinstance(tree, list):
        assert all(item == tree[0] for item in tree)
        return jax.tree_util.tree_map(lambda spec: P(None, *spec), _restack(tree[0]),
                                      is_leaf=lambda x: isinstance(x, P))
    return tree


def _is_spec(x):
    return isinstance(x, P)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_jax(arch):
    shapes, port_tree = _param_shapes(arch)
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    n = 0
    for amesh, tm in _meshes():
        for fsdp in (True, False):
            for layout in ("2d", "dp_only"):
                want = _jax_specs(jsh.param_shardings(shapes, jcfg, amesh, fsdp=fsdp,
                                                      layout=layout), shapes)
                got = tsh.param_shardings(port_tree, tcfg, tm, fsdp=fsdp, layout=layout)
                assert _restack(got) == want, (arch, tm, fsdp, layout)
                n += len(jax.tree_util.tree_leaves(want, is_leaf=_is_spec))
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_shardings_match_jax(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for b in (1, 6, 32, 512):
        batch = {"tokens": (b, 64), "labels": (b, 64), "frames": (b, 16, 8), "scalar": ()}
        jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in batch.items()}
        tb = {k: torch.empty(s, device="meta") for k, s in batch.items()}
        for amesh, tm in _meshes():
            for layout in ("2d", "dp_only"):
                want = _jax_specs(jsh.batch_shardings(jb, jcfg, amesh, layout=layout), jb)
                assert tsh.batch_shardings(tb, tcfg, tm, layout=layout) == want, (b, tm, layout)


def _input_specs_pair(arch: str, kind: str, b: int, s: int):
    from repro.configs.shapes import ShapeSpec as JShape
    from repro_torch.configs.shapes import ShapeSpec as TShape

    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    jspec = jax.eval_shape(lambda: jzoo.input_specs(jcfg, JShape("x", kind, s, b)))
    return jspec, tzoo.input_specs(tcfg, TShape("x", kind, s, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_shardings_match_jax(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for b, s in ((1, 32768), (32, 4096), (32, 1000)):
        jstate = jax.eval_shape(lambda: jtr.init_decode_state(jcfg, b, s))
        tstate = ttr.init_decode_state(tcfg, b, s, device="meta")
        for amesh, tm in _meshes():
            want = _jax_specs(jsh.decode_state_shardings(jstate, jcfg, amesh), jstate)
            assert tsh.decode_state_shardings(tstate, tcfg, tm) == want, (b, s, tm)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_batch_shardings_match_jax(arch):
    """The rules over ``model_zoo.input_specs``' meta tensors (train and decode)."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for kind, b, s in (("train", 256, 4096), ("decode", 32, 4096)):
        jspec, tspec = _input_specs_pair(arch, kind, b, s)
        for amesh, tm in _meshes():
            if kind == "train":
                want = _jax_specs(jsh.batch_shardings(jspec, jcfg, amesh), jspec)
                assert tsh.batch_shardings(tspec, tcfg, tm) == want
            else:
                want = _jax_specs(jsh.decode_state_shardings(jspec["state"], jcfg, amesh),
                                  jspec["state"])
                assert tsh.decode_state_shardings(tspec["state"], tcfg, tm) == want


def _train_state_pair(arch: str):
    shapes, port_tree = _param_shapes(arch)
    jstate = {"params": shapes, "m": shapes, "v": shapes,
              "step": jax.ShapeDtypeStruct((), jnp.int32),
              "lr": jax.ShapeDtypeStruct((), jnp.float32)}
    tstate = {"params": port_tree, "m": port_tree, "v": port_tree,
              "step": torch.empty((), dtype=torch.int32, device="meta"),
              "lr": torch.empty((), device="meta")}
    return jstate, tstate


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_match_jax(arch):
    jstate, tstate = _train_state_pair(arch)
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for amesh, tm in _meshes():
        want = _jax_specs(jsh.train_state_shardings(jstate, jcfg, amesh), jstate)
        got = tsh.train_state_shardings(tstate, tcfg, tm)
        assert {k: _restack(v) for k, v in got.items()} == want, tm


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_departs_from_jax_where_jax_raises(arch):
    jstate, tstate = _train_state_pair(arch)
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for amesh, tm in _meshes():
        with pytest.raises(Exception) as err:
            jsh.train_state_shardings(jstate, jcfg, amesh, zero1=True)
        assert type(err.value).__name__ == "DuplicateSpecError"
        dp = tmesh.data_axes(tm)
        dp_size = 1
        for a in dp:
            dp_size *= tm.shape[a]
        base = _jax_specs(jsh.param_shardings(jstate["params"], jcfg, amesh), jstate["params"])

        def upgrade(spec, shape):
            if set(spec.axes()) & set(dp):
                return spec
            entries = list(spec)
            for i, n in enumerate(shape.shape):
                if entries[i] is None and n % dp_size == 0:
                    entries[i] = dp
                    break
            return P(*entries)

        want = jax.tree_util.tree_map(upgrade, base, jstate["params"], is_leaf=_is_spec)
        got = tsh.train_state_shardings(tstate, tcfg, tm, zero1=True)
        for key in ("m", "v"):
            assert _restack(got[key]) == want, (tm, key)
        assert _restack(got["params"]) == base
        # the unstacked 1-D leaves (final_ln), which FSDP leaves alone, move
        assert want["final_ln"] != base["final_ln"] and "data" in want["final_ln"].axes()


def test_rules_take_a_transformer_and_a_train_state():
    """The rules over the port's own model of a reduced config, as over its
    meta tree; the stacked layers share one spec each."""
    arch = "granite-moe-1b-a400m"
    tcfg = treg.reduced_config(arch, num_layers=2)
    jcfg = jreg.reduced_config(arch, num_layers=2)
    model = ttr.init_model(tcfg, seed=0, device="cpu")
    shapes = jax.eval_shape(lambda: jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    amesh, tm = AbstractMesh((2, 2), ("data", "model")), tmesh.MeshShape((2, 2), ("data", "model"))
    want = _jax_specs(jsh.param_shardings(shapes, jcfg, amesh), shapes)
    assert _restack(tsh.param_shardings(model, tcfg, tm)) == want
    state = Int8ErrorFeedback().init_state(init_adamw_state(model))
    got = tsh.train_state_shardings(state, tcfg, tm)
    assert _restack(got["m"]) == want and got["step"] == P() and got["lr"] == P()
    jstate = {"params": shapes, "m": shapes, "v": shapes, "ef_buffer": shapes,
              "step": jax.ShapeDtypeStruct((), jnp.int32), "lr": jax.ShapeDtypeStruct((), jnp.float32)}
    jwant = _jax_specs(jsh.train_state_shardings(jstate, jcfg, amesh), jstate)
    assert _restack(got["ef_buffer"]) == jwant["ef_buffer"]  # replicated, per layer


def test_partition_spec_normalises_as_jax_does():
    from jax.sharding import PartitionSpec as JP

    for entries in ((("data",), None), ((), "model"), (("data", "model"), None, "pod")):
        assert P(*entries) == tuple(JP(*entries))
    assert P(("data",)) == P("data") and P(()) == P(None)
    assert P(("pod", "data"), None).axes() == ["pod", "data"]
    with pytest.raises(TypeError):
        P(3)


def test_placements_and_local_slices():
    from torch.distributed.tensor import Replicate, Shard

    tm = tmesh.MeshShape((2, 2), ("data", "model"))
    assert tsh.placements(P(("data", "model"), None), tm) == [Shard(0), Shard(0)]
    assert tsh.placements(P("model", "data"), tm) == [Shard(1), Shard(0)]
    assert tsh.placements(P(None, None), tm) == [Replicate(), Replicate()]
    # data is the major axis: the rank at (0, 1) holds rows 2-3 of 8
    assert tsh.local_slices(P(("data", "model"), None), (8, 3), tm, (0, 1)) == (
        slice(2, 4), slice(0, 3))
    assert tsh.local_slices(P("model", "data"), (8, 6), tm, (1, 0)) == (slice(0, 4), slice(3, 6))
    for bad in (P("data", "data"), P(("model", "data"), None), P("pod", None)):
        with pytest.raises(ValueError):
            tsh.placements(bad, tm)
    with pytest.raises(ValueError, match="evenly"):
        tsh.local_slices(P("data", None), (3, 2), tm, (0, 0))


def test_the_rules_refuse_to_shard_a_layer_stack():
    tm = tmesh.MeshShape((2,), ("model",))
    tcfg = treg.reduced_config("internlm2-1.8b")
    # a 1-D leaf per layer, stacked over 4 layers: FSDP's only candidate is the stack
    tree = {"layers": [{"odd": torch.empty(3, device="meta")} for _ in range(4)]}
    with pytest.raises(ValueError, match="layer-stack"):
        tsh.param_shardings(tree, tcfg, tmesh.MeshShape((2, 1), ("data", "model")))
    assert tsh.param_shardings(tree, tcfg, tm)["layers"][0]["odd"] == P(None)


def test_layout_policy_matches_jax():
    for layout in ("2d", "dp_only"):
        with jlayout.layout_scope(layout), tlayout.layout_scope(layout):
            assert tlayout.get_layout() == jlayout.get_layout() == layout
            assert tlayout.batch_axis_tries() == jlayout.batch_axis_tries()
        assert tlayout.get_layout() == "2d"
    with pytest.raises(ValueError):
        tlayout.set_layout("3d")
    for arch in ("internlm2-1.8b", "yi-34b"):
        for kind in ("train", "decode"):
            for thr in (0.0, 2e9):
                assert (tlayout.pick_layout(treg.get_config(arch), kind, dp_threshold=thr)
                        == jlayout.pick_layout(jreg.get_config(arch), kind, dp_threshold=thr))


def test_data_axes_and_the_production_mesh_refusal():
    for shape, axes in MESHES.values():
        assert tmesh.data_axes(tmesh.MeshShape(shape, axes)) == jmesh.data_axes(
            AbstractMesh(shape, axes))
    assert tmesh.MODEL_AXIS == jmesh.MODEL_AXIS
    assert tmesh.MeshShape((2, 16, 16), ("pod", "data", "model")).shape["data"] == 16
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="spawn"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
