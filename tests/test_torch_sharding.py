"""The port's placement layer (``repro_torch.dist.sharding``, ``compat``,
``ctx``; ``launch.mesh``) against the JAX package's, on the CPU.

The cases of ``tests/test_sharding.py`` and ``tests/test_dist_ctx.py`` run
against the port; then, for every leaf of every arch's full config (JAX's
``eval_shape`` against the port's ``meta`` model, layers stacked as JAX's
leaves), every cache leaf and every cell's inputs, and the activation rules
at each arch's shapes, the port's specs equal JAX's on the 16x16 and
2x16x16 production meshes.  A spec is compared as its tuple of entries.
"""
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.dist import sharding as jax_sharding
from repro.launch.steps import eval_shape_cache as jax_eval_shape_cache
from repro.launch.steps import eval_shape_params as jax_eval_shape_params
from repro_torch.configs import ARCHS, get_config, input_specs
from repro_torch.dist.compat import abstract_mesh
from repro_torch.dist.ctx import (activation_sharding_ctx, constrain,
                                  current_rules)
from repro_torch.dist.sharding import (P, NamedSharding, batch_shardings,
                                       batch_spec, cache_shardings,
                                       cache_spec, dp_axes,
                                       make_activation_rules,
                                       param_shardings, param_spec,
                                       shard_dim)
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import eval_shape_cache
from repro_torch.models import SHAPES, build_model

MESH = make_production_mesh()
MESH3 = make_production_mesh(multi_pod=True)
JAX_MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
              True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


# --------------------------------------------------------------------------- #
# tests/test_sharding.py
# --------------------------------------------------------------------------- #


def test_production_meshes():
    assert MESH.shape == {"data": 16, "model": 16}
    assert MESH3.axis_names == ("pod", "data", "model") and MESH3.size == 512


def test_dp_axes():
    assert dp_axes(MESH) == ("data",)
    assert dp_axes(MESH3) == ("pod", "data")


def test_shard_dim_divisibility():
    assert shard_dim(MESH, 4096, "model") == "model"
    assert shard_dim(MESH, 28, "model") is None
    assert shard_dim(MESH, 28, "model", ("data",)) is None
    assert shard_dim(MESH3, 256, ("pod", "data")) == ("pod", "data")


def test_attention_param_rules():
    cfg = get_config("qwen2-7b")
    assert param_spec("layers/attn/wq", (28, 3584, 3584), MESH, cfg) \
        == P(None, "data", "model")
    assert param_spec("layers/attn/wo", (28, 3584, 3584), MESH, cfg) \
        == P(None, "model", "data")
    assert param_spec("layers/norm1", (28, 3584), MESH, cfg) == P()


def test_embed_lm_head_rules():
    cfg = get_config("qwen2-7b")
    assert param_spec("embed", (152064, 3584), MESH, cfg) \
        == P("model", "data")
    assert param_spec("lm_head", (3584, 152064), MESH, cfg) \
        == P("data", "model")


def test_moe_expert_parallelism():
    cfg = get_config("phi3.5-moe-42b-a6.6b")     # 16 experts: EP over model
    spec = param_spec("layers/ffn/w_gate", (32, 16, 4096, 6400), MESH, cfg)
    assert spec == P(None, "model", "data", None)


def test_moe_tp_fallback_when_experts_dont_divide():
    cfg = get_config("mixtral-8x7b")             # 8 experts: TP fallback
    spec = param_spec("layers/ffn/w_gate", (32, 8, 4096, 14336), MESH, cfg)
    assert spec == P(None, None, "data", "model")


def test_slstm_recurrent_weight_replicated():
    cfg = get_config("xlstm-1.3b")
    assert param_spec("blocks/slstm/p/r_z", (6, 2048, 2048), MESH, cfg) \
        == P()
    assert param_spec("blocks/slstm/p/w_z", (6, 2048, 2048), MESH, cfg) \
        == P(None, "data", "model")


def test_batch_specs():
    assert batch_spec("tokens", (256, 4096), MESH) == P("data", None)
    assert batch_spec("tokens", (128,), MESH) == P("data")
    assert batch_spec("tokens", (1, 524288), MESH) == P(None, "data")


def test_kv_cache_specs():
    cfg = get_config("qwen2.5-32b")   # kv=8: heads don't divide 16
    spec = cache_spec("kv/k", (64, 128, 32768, 8, 128), MESH, cfg)
    assert spec[3] is None and spec[4] == "model"
    cfg2 = get_config("qwen1.5-32b")  # kv=40 -> not divisible either
    spec2 = cache_spec("kv/k", (64, 128, 32768, 40, 128), MESH, cfg2)
    assert spec2[4] == "model"


def test_mamba_state_specs():
    cfg = get_config("jamba-1.5-large-398b")
    spec = cache_spec("dense/h", (9, 4, 128, 16384, 16), MESH, cfg)
    assert spec[-2] == "model"


def test_activation_rules_fallback_to_sequence():
    rules = make_activation_rules(MESH, get_config("qwen2-7b"))
    assert rules("heads", (32, 32768, 28, 128)).spec \
        == P("data", "model", None, None)
    rules2 = make_activation_rules(MESH, get_config("mixtral-8x7b"))
    assert rules2("heads", (256, 4096, 32, 128)).spec \
        == P("data", None, "model", None)


# --------------------------------------------------------------------------- #
# every leaf of every full config, both production meshes
# --------------------------------------------------------------------------- #


def specs(tree, prefix=""):
    """path -> spec tuple of a (nested) tree of shardings."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.spec)
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_jax_packages(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = JAX_MESHES[multi_pod]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    meta = build_model(cfg, device="meta")
    got = specs(param_shardings(meta, mesh, cfg))
    _, jtree = jax_eval_shape_params(jcfg)
    want = specs(jax_sharding.param_shardings(jtree, jmesh, jcfg))
    assert got == want
    assert any(s != () for s in got.values())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_jax_packages(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = JAX_MESHES[multi_pod]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for B, S in ((128, 32768), (1, 4096)):
        got = specs(cache_shardings(eval_shape_cache(cfg, B, S), mesh, cfg))
        want = specs(jax_sharding.cache_shardings(
            jax_eval_shape_cache(jcfg, B, S), jmesh, jcfg))
        assert got == want, (B, S)
    for shape in SHAPES.values():
        got = specs(batch_shardings(input_specs(cfg, shape), mesh))
        want = specs(jax_sharding.batch_shardings(
            jax_input_specs(jcfg, shape), jmesh))
        assert got == want, shape.name


def activation_cases(cfg):
    """(name, shape) of every rule name at the shapes this arch gives it,
    at a long-context batch of 1 too."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    E = cfg.n_experts or 8
    out = []
    for B, T in ((256, 4096), (1, 32768)):
        out += [("residual", (B, T, cfg.d_model)), ("tokens", (B, T)),
                ("heads", (B, T, H, hd)), ("heads", (B, T, KV, hd)),
                ("scores", (B, H, T, T)), ("ffn_hidden", (B, T, cfg.d_ff)),
                ("logits", (B, T, cfg.vocab_size)),
                ("expert_tokens4", (E, B, 64, cfg.d_model)),
                ("expert_hidden4", (E, B, 64, cfg.d_ff)),
                ("kv/k", (cfg.n_layers, B, T, KV, hd)),
                ("no_such_rule", (B, T))]
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_equal_the_jax_packages(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    rules = make_activation_rules(mesh, cfg)
    jrules = jax_sharding.make_activation_rules(JAX_MESHES[multi_pod], jcfg)
    for name, shape in activation_cases(cfg):
        got, want = rules(name, shape), jrules(name, shape)
        if want is None:
            assert got is None, name
        else:
            assert tuple(got.spec) == tuple(want.spec), (name, shape)
            assert got.mesh is mesh


# --------------------------------------------------------------------------- #
# meshes and constrain
# --------------------------------------------------------------------------- #


def test_host_mesh_on_the_cpu_and_its_divisibility_error():
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=2, device_type="cpu")
    with pytest.raises(ValueError, match="devices"):
        make_mesh((2, 1), ("data", "model"), [torch.device("cpu")])


def test_constrain_places_the_whole_tensor_on_a_one_device_mesh():
    mesh = make_host_mesh(device_type="cpu")
    rules = make_activation_rules(mesh, get_config("qwen2-7b"))
    x = torch.ones(2, 8, 4, 2)
    seen = []

    def spy(name, shape):
        s = rules(name, shape)
        seen.append(s)
        return s

    with activation_sharding_ctx(spy):
        for name in ("residual", "heads", "scores", "logits", "tokens"):
            assert constrain(x, name) is x
    assert all(s.extent == 1 for s in seen) and len(seen) == 5
    assert seen[1].spec == P("data", None, "model", None)
    assert seen[0].device == torch.device("cpu")


def test_constrain_raises_over_an_extent_of_two():
    """A mesh without devices places nothing: a placement of extent 2 on
    it raises (on a DistMesh it redistributes, tests/test_torch_dist.py)."""
    mesh = abstract_mesh((2, 1), ("data", "model"))
    rules = make_activation_rules(mesh, get_config("qwen2-7b"))
    x = torch.ones(4, 8, 16)
    with activation_sharding_ctx(rules):
        assert rules("residual", tuple(x.shape)).extent == 2
        with pytest.raises(ValueError, match="mesh without devices"):
            constrain(x, "residual")
        y = torch.ones(3, 5, 16)        # no dim divides: replicated
        assert constrain(y, "residual") is y
    with pytest.raises(ValueError, match="DistMesh"):
        NamedSharding(mesh, P()).device


# --------------------------------------------------------------------------- #
# tests/test_dist_ctx.py
# --------------------------------------------------------------------------- #


def test_constrain_is_identity_outside_ctx():
    x = torch.arange(8.0).reshape(2, 4)
    assert current_rules() is None
    assert constrain(x, "residual") is x


def test_unknown_rule_name_and_none_are_noops():
    rules = make_activation_rules(make_host_mesh(device_type="cpu"),
                                  get_config("qwen2-7b"))
    x = torch.ones(4, 4)
    with activation_sharding_ctx(rules):
        assert constrain(x, "no_such_rule_name") is x
    with activation_sharding_ctx(lambda name, shape: None):
        assert constrain(x, "residual") is x


def test_ctx_restores_on_exit_nests_and_survives_an_exception():
    outer = make_activation_rules(make_host_mesh(device_type="cpu"),
                                  get_config("qwen2-7b"))
    inner = lambda name, shape: None   # noqa: E731
    with activation_sharding_ctx(outer):
        with activation_sharding_ctx(inner):
            assert current_rules() is inner
        assert current_rules() is outer
    assert current_rules() is None
    with pytest.raises(ValueError):
        with activation_sharding_ctx(outer):
            raise ValueError("boom")
    assert current_rules() is None


def test_jax_abstract_meshes_are_the_ports():
    for multi_pod, jmesh in JAX_MESHES.items():
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.axis_names) == tuple(jmesh.axis_names)
        assert dict(mesh.shape) == dict(jmesh.shape)
