"""The port's sharding policy and spec tables against ``repro.sharding``.

The policies read only a mesh's axis names and shape, so a stub mesh with
both packages' attributes (``axis_names``/``devices`` for the reference,
``mesh_dim_names``/``mesh`` for the port) serves every table here, at the
production shapes, in one CPU process.  The reference's ``NamedSharding``
needs a real mesh, so its table functions run with ``NamedSharding``
patched to return the bare spec; its own code computes every spec.

Specs are compared entry by entry: the reference's ``PartitionSpec`` as a
tuple against the port's tuple.  The port's per-layer params have no stack
dim and must get the reference's spec for the stacked leaf with its
leading ``None`` dropped.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.sharding.specs as jax_specs  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.sharding.policy import ShardingPolicy as JaxPolicy  # noqa: E402
from repro_torch.configs import _MODULES, get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import RECURRENT  # noqa: E402
from repro_torch.sharding import shard, use_policy  # noqa: E402
from repro_torch.sharding.policy import (ShardingPolicy,  # noqa: E402
                                         placements)
from repro_torch.sharding.specs import (bytes_per_device,  # noqa: E402
                                        cache_shardings, input_shardings,
                                        param_shardings, param_spec)

ARCHS = sorted(_MODULES)
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 4): ("data", "model"),
          (1, 8): ("data", "model")}
BATCH, MAX_LEN = 32, 4096


class StubMesh:
    def __init__(self, shape, axes):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = axes
        self.mesh = self.devices
        self.mesh_dim_names = axes


@pytest.fixture
def policy():
    return ShardingPolicy(StubMesh((16, 16), ("data", "model")))


@pytest.fixture
def policy3d():
    return ShardingPolicy(StubMesh((2, 16, 16), ("pod", "data", "model")))


# ------------------------------------- the reference's eight cases ----

def test_batch_sharded_over_data(policy):
    spec = policy.spec(("batch", "seq", "act_embed"), (256, 4096, 1024))
    assert spec == ("data", None, None)


def test_pod_axis_joins_batch(policy3d):
    spec = policy3d.spec(("batch", "seq", "act_embed"), (256, 4096, 1024))
    assert spec == (("pod", "data"), None, None)


def test_divisibility_fallback_drops_axis(policy):
    spec = policy.spec(("batch", "seq", "heads", "head_dim"),
                       (32, 128, 24, 128))
    assert spec == ("data", None, None, None)
    spec = policy.spec(("batch", "seq", "heads", "head_dim"),
                       (32, 128, 96, 128))
    assert spec == ("data", None, "model", None)


def test_axis_used_once(policy):
    spec = policy.spec(("heads", "act_mlp"), (32, 1024))
    assert spec == ("model", None)


def test_long_seq_rule(policy):
    spec = policy.spec(("stack", "long_seq", "kv_heads"), (8, 524288, 8))
    assert spec[1] == "data"


def test_param_spec_fsdp_tp(policy):
    spec = param_spec("['stack']['p0']['mlp']['wu']", (96, 18432, 73728),
                      policy)
    assert spec == (None, "data", "model")
    spec = param_spec("['embed']", (256000, 18432), policy)
    assert spec == ("model", "data")
    spec = param_spec("['final_norm']['scale']", (18432,), policy)
    assert spec == (None,)


def test_param_spec_indivisible_replicates(policy):
    assert param_spec("['x']", (7, 13), policy) == (None, None)


def test_rule_override():
    pol = ShardingPolicy(StubMesh((4, 2), ("data", "model")),
                         rules={"act_mlp": ("data",)})
    assert pol.spec(("batch", "act_mlp"), (1, 8)) == (None, "data")


# ----------------------------------------------------- placements ----

def test_placements_follow_the_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StubMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(mesh, (None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="axis order"):
        placements(mesh, (("data", "pod"),))


def test_shard_is_the_identity_on_plain_tensors(policy):
    x = torch.ones(4, 3)
    assert shard(x, "batch", "act_embed") is x          # no policy
    with use_policy(policy):
        assert shard(x, "batch", "act_embed") is x      # plain tensor
        assert shard(x, "batch") is x                   # rank mismatch


# ------------------------------------------- the embedding quirk ----

def test_embedding_branch_never_fires_on_a_keystr_path():
    """Both packages' ``param_spec`` test ``path.endswith("embed")``, which
    the keystr path ``"['embed']"`` never meets: Seamless's 256,206-row
    table takes the generic branch (model on d_model, vocab indivisible),
    where the branch meant for it would put data on d_model."""
    shape = (256206, 1024)
    stub = StubMesh((16, 16), ("data", "model"))
    jp, tp = JaxPolicy(stub), ShardingPolicy(stub)
    assert tuple(jax_specs.param_spec("['embed']", shape, jp)) \
        == param_spec("['embed']", shape, tp) == (None, "model")
    assert tuple(jax_specs.param_spec("embed", shape, jp)) \
        == param_spec("embed", shape, tp) == (None, "data")


# ------------------------------------ tables at the full shapes ----

def _bare_specs(monkeypatch):
    monkeypatch.setattr(jax_specs, "NamedSharding", lambda mesh, spec: spec)


def _ref_param_specs(tree, pol):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(jax_specs.param_spec(
        jax.tree_util.keystr(p), x.shape, pol)), x) for p, x in flat}


def _port_param_specs(params, shardings, jm):
    """{reference keystr path: (port spec, with the stack None put back)}
    for every port leaf."""
    out = {}

    def walk(node, sh, keys):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], sh[k], keys + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, sh[i], keys + (i,))
        else:
            if keys[0] in ("layers", "enc_layers"):
                stack = "stack" if keys[0] == "layers" else "enc_stack"
                pos = keys[1] % jm.period if keys[0] == "layers" else 0
                path = "".join(f"[{k!r}]" for k in
                               (stack, f"p{pos}") + keys[2:])
                out.setdefault(path, set()).add((None,) + sh.spec)
            else:
                path = "".join(f"[{k!r}]" for k in keys)
                out.setdefault(path, set()).add(sh.spec)
    walk(params, shardings, ())
    return out


_ABSTRACT = {}


def _abstract(arch):
    if arch not in _ABSTRACT:
        jm, tm = JaxModel(jax_config(arch)), Model(get_config(arch))
        _ABSTRACT[arch] = (jm, jm.init_abstract(jnp.bfloat16), tm,
                           tm.init_abstract(torch.bfloat16))
    return _ABSTRACT[arch]


def _policies(rules=None):
    for shape, axes in MESHES.items():
        stub = StubMesh(shape, axes)
        yield shape, JaxPolicy(stub, rules), ShardingPolicy(stub, rules)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    jm, jtree, tm, tparams = _abstract(arch)
    for mesh, jpol, tpol in [*_policies(),
                             *((s, j, t) for s, j, t in
                               _policies({"_no_fsdp": True})
                               if s == (16, 16))]:
        ref = _ref_param_specs(jtree, jpol)
        port = _port_param_specs(tparams, param_shardings(tparams, tpol), jm)
        assert set(port) == set(ref), mesh
        for path, specs in port.items():
            assert specs == {ref[path][0]}, (arch, mesh, path)


def _ref_cache_leaf(path, jm):
    """A reference cache keystr path (``['p<j>']['kv']['k']``,
    ``['p<j>']['state'][<name>]``, ``['p<j>']['xk']``) -> the port's leaf
    name: a recurrent state's takes its mixer kind's prefix."""
    keys = [k.strip("'") for k in path.strip("[]").split("][")]
    if keys[1] == "state":
        mixer = jm.descs[int(keys[0][1:])].mixer
        return RECURRENT[mixer].prefix + keys[2]
    return keys[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_the_reference(arch, monkeypatch):
    _bare_specs(monkeypatch)
    jm, _, tm, _ = _abstract(arch)
    jcache = jm.cache_init(BATCH, MAX_LEN, abstract=True)
    tcache = tm.cache_init(BATCH, MAX_LEN, "meta")
    cases = [(mesh, j, t, {}) for mesh, j, t in _policies()]
    cases += [(mesh, j, t, {"long_context": True})
              for mesh, j, t in _policies() if mesh == (16, 16)]
    cases += [(mesh, j, t, {}) for mesh, j, t in
              _policies({"_kv_seq_model": True}) if mesh == (16, 16)]
    for mesh, jpol, tpol, kw in cases:
        ref = jax_specs.cache_shardings(jcache, jpol, **kw)
        flat = jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: isinstance(x, P))[0]
        port = cache_shardings(tcache, tpol, **kw)
        seen = set()
        for path, spec in flat:
            name = _ref_cache_leaf(jax.tree_util.keystr(path), jm)
            assert port[name].spec == tuple(spec), (arch, mesh, kw, name)
            seen.add(name)
        assert seen == set(tcache)
        if tm.supports_paged_decode:
            jpool = jm.paged_cache_init(63, 16, abstract=True)
            tpool = tm.paged_cache_init(63, 16, "meta")
            ref = jax_specs.cache_shardings(jpool, jpol, **kw)
            for name, sh in cache_shardings(tpool, tpol, **kw).items():
                assert sh.spec == tuple(ref["p0"]["kv"][name])
        inputs = {"tokens": (BATCH, 2048), "lengths": (BATCH,),
                  "odd": (3, 5), "step": ()}
        ref = jax_specs.input_shardings(
            {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in inputs.items()},
            jpol, **kw)
        port = input_shardings(
            {k: torch.empty(s, dtype=torch.int32, device="meta")
             for k, s in inputs.items()}, tpol, **kw)
        assert {k: sh.spec for k, sh in port.items()} == \
            {k: tuple(s) for k, s in ref.items()}


def _ref_bytes(tree, pol):
    sizes = dict(zip(pol.mesh.axis_names, pol.mesh.devices.shape))
    total = 0
    for spec, x in _ref_param_specs(tree, pol).values():
        n = 1
        for dim, entry in zip(x.shape, spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        total += n * np.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,mesh", [("llama-3.1-70b", (1, 4)),
                                       ("nemotron-4-340b", (1, 8))])
def test_bytes_per_device_at_the_papers_tensor_parallel_degree(arch, mesh):
    """The paper's topologies (Llama-3.1-70B at TP = 4, Nemotron-4-340B at
    TP = 8), as spec tables on abstract params: both packages put the same
    bytes on each device, and every weight is split over ``model``."""
    jm, jtree, tm, tparams = _abstract(arch)
    stub = StubMesh(mesh, ("data", "model"))
    port = bytes_per_device(tparams, param_shardings(
        tparams, ShardingPolicy(stub)))
    assert port == _ref_bytes(jtree, JaxPolicy(stub))
    total = sum(int(np.prod(x.shape)) * 2 for x in jax.tree.leaves(jtree))
    assert total / mesh[1] <= port < total / mesh[1] * 1.01
