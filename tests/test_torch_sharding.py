"""The port's logical-axis sharding against the JAX package's.

* The rule cases of ``tests/test_training.py`` (head and expert
  fallbacks, multi-pod FSDP axes, serve's TP-only layout, boxing round
  trip), the same specs on both sides.
* Every arch at full published width: the port's shape-only annotated
  tree (``Model.init_annotated(device="meta")``, which draws and
  allocates nothing) against ``jax.eval_shape(model.init)``, leaf for
  leaf in path, shape, dtype and logical axes; its spec trees under
  train/serve on the single- and multi-pod production meshes against
  JAX's ``spec_tree``; ``Model.cache_axes`` against the reference's at a
  ``max_len`` below and above each window.
* ``placements`` on a stand-in mesh (only its dim names are read), and
  the activation context: ``shard_act`` and ``active_flag``.

Nothing here needs a process group; ``tests/test_torch_distributed.py``
lays real tensors out over gloo ranks.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs.base import MULTI_POD_MESH as J_MULTI
from repro.configs.base import SINGLE_POD_MESH as J_SINGLE
from repro.distributed import sharding as JS
from repro.models import build_model as jax_build_model
from repro_torch import tree as TR
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import MULTI_POD_MESH, SINGLE_POD_MESH
from repro_torch.distributed import sharding as S
from repro_torch.models import build_model
from repro_torch.models import layers as L

ARCHS = list_archs()
MESHES = {"single": (SINGLE_POD_MESH, J_SINGLE),
          "multi": (MULTI_POD_MESH, J_MULTI)}


def jspec(p) -> tuple:
    """A JAX PartitionSpec as the port's plain tuple."""
    return tuple(p)


# ---------------------------------------------------------- the rule cases
def test_rules_divisibility_fallback():
    """starcoder2: 24 heads don't divide tp=16 -> head_dim takes the model
    axis; nemotron: 96 heads divide -> heads take it."""
    sc = get_config("starcoder2-3b")
    rules = S.make_rules(sc, SINGLE_POD_MESH, "train")
    spec = rules.spec_for(("embed", "heads", "head_dim"),
                          (sc.d_model, sc.num_heads, sc.head_dim))
    assert spec == ("data", None, "model")
    nm = get_config("nemotron-4-340b")
    rules = S.make_rules(nm, SINGLE_POD_MESH, "train")
    spec = rules.spec_for(("embed", "heads", "head_dim"),
                          (nm.d_model, nm.num_heads, nm.head_dim))
    assert spec == ("data", "model")  # tail trimmed


def test_rules_expert_fallback():
    """grok: 8 experts don't divide 16 -> mlp dim sharded inside experts;
    jamba: 16 experts divide -> expert axis sharded."""
    grok = get_config("grok-1-314b")
    rules = S.make_rules(grok, SINGLE_POD_MESH, "train")
    spec = rules.spec_for(("expert", "embed", "mlp"),
                          (8, grok.d_model, grok.d_ff))
    assert spec == (None, "data", "model")
    jam = get_config("jamba-1.5-large-398b")
    rules = S.make_rules(jam, SINGLE_POD_MESH, "train")
    spec = rules.spec_for(("expert", "embed", "mlp"),
                          (16, jam.d_model, jam.d_ff))
    assert spec == ("model", "data")


def test_rules_multipod_fsdp_axes():
    cfg = get_config("nemotron-4-340b")
    rules = S.make_rules(cfg, MULTI_POD_MESH, "train")
    spec = rules.spec_for(("embed", "mlp"), (cfg.d_model, cfg.d_ff))
    assert spec == (("pod", "data"), "model")


def test_serve_mode_tp_only_for_small_archs():
    small = get_config("olmo-1b")
    rules = S.make_rules(small, SINGLE_POD_MESH, "serve")
    spec = rules.spec_for(("embed", "mlp"), (small.d_model, small.d_ff))
    assert spec == (None, "model")
    big = get_config("nemotron-4-340b")
    rules = S.make_rules(big, SINGLE_POD_MESH, "serve")
    spec = rules.spec_for(("embed", "mlp"), (big.d_model, big.d_ff))
    assert spec == ("data", "model")


def test_param_boxing_roundtrip():
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    ann = model.init_annotated(0, device="cpu")
    vals = S.unbox(ann)
    flat_v = TR.leaves(vals)
    flat_a = [p.axes for p in TR.leaves(ann)]
    assert len(flat_v) == len(flat_a)
    for v, a in zip(flat_v, flat_a):
        assert v.ndim == len(a)
    # the boxed tree holds init's values: the same draws in the same order
    assert all(torch.equal(a, b) for a, b in
               zip(flat_v, TR.leaves(model.init(0, device="cpu"))))
    # prepend_axis and axes_tree, on a tree that also holds a plain leaf
    tree = {"w": S.Param(torch.zeros(2, 3), ("embed", "mlp")), "n": 1}
    assert S.axes_tree(S.prepend_axis("layers", tree)) == {
        "n": None, "w": ("layers", "embed", "mlp")}


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_matches_jax_on_axis_combinations(mode, mesh):
    """spec_for against the reference on 300 random tuples of one to
    three logical axes (weight, activation and cache names, None) at dims
    that divide by 16, by 32, by both or by neither."""
    mcfg, jmcfg = MESHES[mesh]
    names = ["embed", "mlp", "heads", "kv_heads", "head_dim", "vocab",
             "expert", "ssm_inner", None, "batch", "cache_seq", "act_seq"]
    dims = [8, 16, 24, 32, 96]
    rng = np.random.default_rng(0)
    for arch in ("olmo-1b", "nemotron-4-340b"):
        rules = S.make_rules(get_config(arch), mcfg, mode)
        jrules = JS.make_rules(jax_get_config(arch), jmcfg, mode)
        for _ in range(300):
            n = int(rng.integers(1, 4))
            axes = tuple(names[i] for i in rng.integers(0, len(names), n))
            shape = tuple(int(dims[i]) for i in rng.integers(0, len(dims), n))
            assert rules.spec_for(axes, shape) == \
                jspec(jrules.spec_for(axes, shape)), (axes, shape)


# ------------------------------------------- every arch at full width
@functools.lru_cache(maxsize=None)
def jax_abstract(arch: str):
    """JAX's annotated init at full width, shapes only: [(path, Param)]."""
    model = jax_build_model(jax_get_config(arch))
    ann = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(ann, is_leaf=JS.is_param)
    return ann, [(jax.tree_util.keystr(path), p) for path, p in flat]


@functools.lru_cache(maxsize=None)
def port_abstract(arch: str):
    """The port's annotated init at full width on the meta device."""
    return build_model(get_config(arch)).init_annotated(device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_annotated_tree_matches_jax(arch):
    ann = port_abstract(arch)
    mine = TR.flatten_with_paths(ann)
    _, theirs = jax_abstract(arch)
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        assert S.is_param(a), path
        assert a.value.device.type == "meta", path
        assert tuple(a.value.shape) == tuple(b.value.shape), path
        assert str(a.value.dtype).removeprefix("torch.") == \
            np.dtype(b.value.dtype).name, path
        assert a.axes == b.axes, path


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_spec_trees_match_jax(arch, mode):
    ann = port_abstract(arch)
    jann, _ = jax_abstract(arch)
    for mcfg, jmcfg in MESHES.values():
        rules = S.make_rules(get_config(arch), mcfg, mode)
        specs = S.spec_tree(rules, ann)
        jspecs = JS.spec_tree(JS.make_rules(jax_get_config(arch), jmcfg,
                                            mode), jann)
        jflat, _ = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, P))
        want = [(jax.tree_util.keystr(p), jspec(s)) for p, s in jflat]
        # a spec is a tuple, which the tree walkers descend: box each one
        # at its parameter's place to list them in leaf order
        got = TR.flatten_with_paths(TR.map_tree(
            lambda _, s: types.SimpleNamespace(spec=s), ann, specs))
        assert [(path, n.spec) for path, n in got] == want, (arch, mode,
                                                              mcfg)
        # make_shardings carries the same specs
        shardings = S.make_shardings(None, rules, ann)
        assert [s.spec for s in TR.leaves(shardings)] == [s for _, s in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_jax(arch):
    cfg = get_config(arch)
    model = build_model(cfg)
    jmodel = jax_build_model(jax_get_config(arch))
    window = cfg.sliding_window or 4096
    for max_len in (window // 2, window, 2 * window):
        axes = model.cache_axes(max_len)
        assert axes == jmodel.cache_axes(max_len), (arch, max_len)
        cache = model.init_cache(1, max_len, device="meta")
        got = [a.dim() for a in TR.leaves(cache)]
        # each leaf's axes tuple: the tree's tuples are its leaves here
        want = [len(a) for a in _axes_leaves(axes)]
        assert got == want, (arch, max_len)
        assert all(a.device.type == "meta" for a in TR.leaves(cache))


def _axes_leaves(tree):
    """An axes tree's tuples, in the port's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    if isinstance(tree, list):
        return [a for sub in tree for a in _axes_leaves(sub)]
    return [tree]


def test_windowed_cache_is_ring_only_below_max_len():
    """gemma2's local layers: a ring (not sequence-sharded) only when the
    window is shorter than max_len, as the reference decides."""
    model = build_model(get_config("gemma2-2b"))
    below, above = model.cache_axes(8192), model.cache_axes(2048)
    assert below[0]["k"] == ("layers", "cache_batch", None,
                             "cache_kv_heads", "cache_head_dim")
    assert above[0]["k"][2] == "cache_seq"
    assert below[1]["k"][2] == "cache_seq"        # the global layer


def test_mesh_configs_and_the_production_mesh_refuses_a_smaller_world():
    """The production meshes are the reference's; without a process group
    of 256 (512) ranks make_production_mesh raises, it never builds a
    smaller mesh."""
    from repro.launch.mesh import mesh_config as jax_mesh_config
    from repro_torch.launch.mesh import make_production_mesh, mesh_config
    for multi_pod in (False, True):
        cfg, jcfg = mesh_config(multi_pod=multi_pod), \
            jax_mesh_config(multi_pod=multi_pod)
        assert (cfg.shape, cfg.axes) == (jcfg.shape, jcfg.axes)
        with pytest.raises(RuntimeError, match=f"{cfg.num_devices} ranks"):
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")


# ------------------------------------------------------------ placements
def stand_in_mesh(*names):
    return types.SimpleNamespace(mesh_dim_names=names)


def test_placements_map_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = stand_in_mesh("pod", "data", "model")
    assert S.placements(mesh, (("pod", "data"), "model"), 2) == (
        Shard(0), Shard(0), Shard(1))
    assert S.placements(mesh, (None, None, "data"), 3) == (
        Replicate(), Shard(2), Replicate())
    assert S.placements(mesh, (), 2) == (Replicate(),) * 3
    # a spec trimmed of trailing Nones shards the leading dims only
    assert S.placements(stand_in_mesh("data", "model"), ("model",), 3) == (
        Replicate(), Shard(0))


@pytest.mark.parametrize("spec", [
    (("data", "pod"),),        # minor before major: DTensor cannot say it
    ("data", "data"),          # one mesh axis twice
    ("expert",),               # not a mesh axis
    ("data", None, "model"),   # more entries than dims
])
def test_placements_refuse(spec):
    with pytest.raises(ValueError):
        S.placements(stand_in_mesh("pod", "data", "model"), spec, 2)


# ------------------------------------------------------ activation context
def test_shard_act_and_active_flag_without_and_with_context():
    x = torch.ones(2, 8, 4)
    assert S.shard_act(x, "batch", None, "act_embed") is x
    assert not S.active_flag("single_q_block")
    rules = S.make_rules(get_config("olmo-1b"), SINGLE_POD_MESH, "train",
                         flags=("single_q_block",))
    with S.set_active(stand_in_mesh("data", "model"), rules):
        assert S.active_flag("single_q_block")
        assert not S.active_flag("kv_seq_sharded")
        # a plain tensor is left alone under a context too
        assert S.shard_act(x, "batch", None, "act_embed") is x
        with S.set_active(None, None):
            assert not S.active_flag("single_q_block")
        assert S.active_flag("single_q_block")
    assert not S.active_flag("single_q_block")


def test_single_q_block_flag_reaches_blocked_attention(monkeypatch):
    """Under the flag the plain path attends in one q block spanning the
    sequence, as the reference's attention_forward does; the output is the
    same function (CPU matmuls over other views may sum in another order,
    so it is held to the norm, as fp32 outputs near zero amplify a
    relative difference)."""
    cfg = get_config("olmo-1b").reduced()
    p = L.attention_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    p = {k: v.float() for k, v in p.items()}
    x = torch.randn(1, 600, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(600)[None]
    seen = []
    real = L.blocked_attention

    def spy(*a, **kw):
        seen.append(kw["block_q"])
        return real(*a, **kw)

    monkeypatch.setattr(L, "blocked_attention", spy)
    want, _ = L.attention_forward(cfg, p, x, pos, attn_impl="plain")
    rules = S.make_rules(cfg, SINGLE_POD_MESH, "train",
                         flags=("single_q_block",))
    with S.set_active(stand_in_mesh("data", "model"), rules):
        got, _ = L.attention_forward(cfg, p, x, pos, attn_impl="plain")
    assert seen == [512, 600]
    # another blocking of the same fp32 products: within 2e-5 of the norm
    assert float((got - want).norm() / want.norm()) < 2e-5
