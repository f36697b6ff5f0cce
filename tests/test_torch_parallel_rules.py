"""The port's mesh spec and sharding rule table against the JAX package,
on the CPU (no process group needed).

For every parameter of the debug Llama, Mixtral and int8 Llama, the
port's spec equals the reference's spec for the counterpart leaf, on
several meshes of the reference's 8 virtual devices, transposed where
the port stores (out, in).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import Llama as JLlama
from ray_tpu.models import LlamaConfig as JConfig
from ray_tpu.models import Mixtral as JMixtral
from ray_tpu.models import MixtralConfig as JMixtralConfig
from ray_tpu.ops.quant import quantize_llama_params as j_quantize
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import build_mesh as j_build_mesh
from ray_tpu.parallel import partition_spec_for as j_spec_for
from ray_tpu_torch.models import Llama, LlamaConfig, Mixtral, MixtralConfig
from ray_tpu_torch.parallel import MeshSpec, partition_spec_for
from ray_tpu_torch.parallel.mesh import fsdp_mesh_spec, local_mesh_spec


def _port_leaf(path, arr):
    """The port's name of a flax leaf, and whether its layout is the
    transpose ((in, out) kernels become (out, in) weights)."""
    leaf, base = path[-1], ".".join(path[:-1])
    if leaf in ("kernel", "kernel_q") and arr.ndim == 2:
        return f"{base}.{'weight' if leaf == 'kernel' else 'kernel_q'}", True
    if leaf == "embedding":
        return f"{base}.weight", False
    return ".".join(path), False


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def families():
    ljcfg = JConfig.debug(dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    lparams = JLlama(ljcfg).init(jax.random.PRNGKey(0), tokens)["params"]
    mjcfg = JMixtralConfig.debug(dtype=jnp.float32)
    mparams = JMixtral(mjcfg).init(jax.random.PRNGKey(0), tokens)["params"]
    qparams = j_quantize(lparams)
    return {
        "llama": (lparams, Llama(LlamaConfig.debug(), device="cpu")),
        "mixtral": (mparams, Mixtral(MixtralConfig.debug(), device="cpu")),
        "int8": (qparams, Llama(LlamaConfig.debug(quant="int8"),
                                device="cpu")),
    }


@pytest.mark.parametrize("spec", [
    dict(fsdp=2, tp=4), dict(dp=2, ep=2, tp=2), dict(fsdp=8),
    dict(ep=4, fsdp=2), dict(tp=8)])
def test_rules_match_reference(families, spec):
    """Every leaf of every family: the port's spec for its name and
    shape is the reference's for the flax leaf (transposed for (out,
    in)); every port parameter is covered."""
    mesh = j_build_mesh(JMeshSpec(**spec), devices=jax.devices()[:8])
    checked = 0
    for family, (params, model) in families.items():
        port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        seen = set()
        for path, arr in _flat(jax.tree.map(np.asarray, params)):
            name, transposed = _port_leaf(path, arr)
            want = _padded(j_spec_for("/".join(path), arr.shape, mesh),
                           arr.ndim)
            if transposed:
                want = want[::-1]
            assert name in port, (family, name)
            got = _padded(partition_spec_for(name, port[name],
                                             MeshSpec(**spec)), arr.ndim)
            assert got == want, (family, name, got, want)
            seen.add(name)
            checked += 1
        assert seen == set(port), (family, set(port) - seen)
    assert checked > 50


def test_mesh_spec_validation():
    """The reference's test: a spec must match the world (here checked
    against a given device count; build_mesh checks the world size)."""
    with pytest.raises(ValueError):
        MeshSpec(dp=3, tp=2).validate(8)
    MeshSpec(dp=2, fsdp=2, tp=2).validate(8)
    assert MeshSpec(dp=2, tp=4).nontrivial_axes() == ["dp", "tp"]
    assert MeshSpec(dp=2, tp=4).size == 8
    assert fsdp_mesh_spec(4) == MeshSpec(fsdp=4)
    assert local_mesh_spec(tp=2) == MeshSpec(tp=2)
