"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's: the eight substrate cases on the same fake meshes, and
``params_shardings`` for every parameter of all ten configs at full size
(the port's modules on ``meta``, the reference's ``jax.eval_shape``) on
the 16x16 and 2x16x16 production meshes, leaf for leaf -- C12 (the
reference reads a MoE stack's layer axis as its expert axis) included.
Specs are exact (tuples equal to the ``PartitionSpec`` entries)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.dist import sharding as ref
from repro.models.zoo import build_model as jax_build
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import params_from_jax  # noqa: F401 (layout doc)
from repro_torch.dist.sharding import (batch_spec, cache_spec, param_spec,
                                       param_specs, params_shardings,
                                       stacked_shapes)
from repro_torch.models.rwkv6 import RWKV6
from repro_torch.models.transformer import Transformer
from repro_torch.models.zoo import Zamba2


class FakeMesh:
    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = names


MESH = FakeMesh((16, 16), ("data", "model"))
MESH3 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
P = jax.sharding.PartitionSpec


# ------------------------------------------- the reference's eight cases
def test_param_spec_tp_prefers_last_dim():
    assert param_spec((4096, 13440), MESH, False, False) == \
        tuple(P("data", "model"))


def test_param_spec_odd_heads_falls_back():
    assert "model" in param_spec((3072, 3072), MESH, False, False)


def test_param_spec_indivisible_replicates():
    assert param_spec((7, 13), MESH, False, False) == tuple(P(None, None))


def test_param_spec_stacked_skips_layer_axis():
    assert param_spec((61, 7168, 2048), MESH, True, False)[0] is None


def test_param_spec_expert_axis():
    assert param_spec((256, 7168, 2048), MESH, False, True)[0] == "model"


def test_batch_spec_long500k_batch1():
    assert batch_spec((1, 1), MESH) == tuple(P(None, None))


def test_cache_spec_mqa_shards_sequence():
    spec = cache_spec((88, 128, 1, 32768, 128), MESH)
    assert spec[3] == "model" or spec[4] == "model"


def test_multipod_spec():
    spec = param_spec((8192, 8192), MESH3, False, False)
    flat = [s for s in spec if s is not None]
    assert ("pod", "data") in spec or "data" in flat


@pytest.mark.parametrize("shape", [(4096, 13440), (7, 13), (61, 7168, 2048),
                                   (256, 7168, 2048), (1, 1), (48, 5120),
                                   (88, 128, 1, 32768, 128), (8192, 8192),
                                   (128, 32, 8, 32768, 64), (64,)])
@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["16x16", "2x16x16"])
def test_rules_equal_the_reference(shape, mesh):
    for stacked in (False, True):
        for expert in (False, True):
            assert param_spec(shape, mesh, stacked, expert) == \
                tuple(ref.param_spec(shape, mesh, stacked, expert))
    assert batch_spec(shape, mesh) == tuple(ref.batch_spec(shape, mesh))
    assert cache_spec(shape, mesh) == tuple(ref.cache_spec(shape, mesh))


# ---------------------------------------------- every parameter, ten configs
def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _meta_params(cfg):
    cls = {"ssm": RWKV6, "hybrid": Zamba2}.get(cfg.family, Transformer)
    return cls(cfg, None, torch.device("meta"))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_params_shardings_equal_the_reference(arch_id):
    cfg = get_config(arch_id)
    params = _meta_params(cfg)
    shapes = stacked_shapes(params)
    jshapes = jax.eval_shape(jax_build(jax_get_config(arch_id)).init,
                             jax.random.PRNGKey(0))
    got_shapes = dict(_flat(shapes))
    want_shapes = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
                   jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert got_shapes == want_shapes
    for mesh in (MESH, MESH3):
        got = dict(_flat(params_shardings(shapes, mesh)))
        want = {jax.tree_util.keystr(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    ref.params_shardings(jshapes, mesh),
                    is_leaf=lambda x: isinstance(x, P))[0]}
        assert got == want
        # a per-layer parameter: its stacked leaf's spec minus the layer axis
        per = param_specs(params, mesh)
        for name, p in params.named_parameters():
            assert len(per[name]) == p.ndim, name
            keys = [k for k in name.split(".") if not k.isdigit()]
            leaf = "".join(f"[{k!r}]" for k in keys)
            stacked = name != ".".join(keys)
            assert per[name] == (got[leaf][1:] if stacked else got[leaf])


def test_c12_moe_layer_axis_read_as_expert_axis():
    """The reference's reading, kept: llama4-maverick's MoE stack shards
    its 48 layers on "model" and never its 128 experts; deepseek-v3's 58
    MoE layers do not divide by 16, so its stack falls through to the
    last axis.  The port's per-layer tensors replicate that axis."""
    for mesh in (MESH, MESH3):
        specs = params_shardings(stacked_shapes(_meta_params(
            get_config("llama4-maverick-400b-a17b"))), mesh)
        moe = specs["moe_layers"]
        dp = "data" if mesh is MESH else ("pod", "data")
        assert moe["ffn"]["wi_gate"] == ("model", dp, None, None)
        assert moe["ln1"] == ("model", dp)
        ds = params_shardings(stacked_shapes(_meta_params(
            get_config("deepseek-v3-671b"))), mesh)["moe_layers"]
        assert ds["ffn"]["wi_gate"] == (None, dp, None, "model")
    per = param_specs(_meta_params(get_config("llama4-maverick-400b-a17b")),
                      MESH)
    assert per["moe_layers.0.ffn.wi_gate"] == ("data", None, None)
