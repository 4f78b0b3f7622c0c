"""PyTorch port vs JAX package: SFNet and SFNetRefFusion, their frequency
modules (Gap, PatchAP, SFconv, DynamicFilter at ks 3 and 5, TLC pooling),
BatchNorm in train and eval mode against flax's, and the weight
conversion both ways (BN statistics, the transposed convs' flip, the dead
lamb_l / lamb_h).  The training step and the evaluation CLI are in
tests/test_torch_sfnet_train.py.

Weights are drawn at a trained network's scale (`trained_scale`: convs
N(0, 1/fan_in), norm weights near 1): at the tiny scale of
`torch_port_util.randomize` the SCM's InstanceNorm sees channels whose
variance is a small difference of E[x^2] and E[x]^2, and both packages'
f32 cancellation error there would measure summation order, not the
port.  f32 on the CPU: modules to 1e-5, networks to 1e-5
relative in L2 at each scale and 1e-4 elementwise; bf16 within C3's 3%.
JAX parameters and batch_stats come from the port's state dict through the
JAX package's `convert_state_dict` and `split_batch_stats`, never
`model.init`; the JAX networks run jitted.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from textualdegremoval_tpu.convert import convert_state_dict
from textualdegremoval_tpu.convert.torch_to_jax import split_batch_stats
from textualdegremoval_tpu.models import sfnet as js

from textualdegremoval_tpu_torch.convert import (
    load_jax_params, load_reference_checkpoint,
)
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models import sfnet as ps

from torch_oracles import OSFNetRefFusion
from torch_port_util import assert_close, randn, t

TINY = dict(num_res=1, base_channel=8)
TINY_REF = dict(TINY, nf=8, ext_n_blocks=(1, 1, 1),
                reffusion_n_blocks=(1, 1, 1), lr_block_size=4)


def trained_scale(module: torch.nn.Module, seed: int):
    """Seeded weights at a trained network's scale: conv and linear
    weights N(0, 1/fan_in), norm and BN weights 1 + N(0, 0.1^2), the
    fusion gates in [0.25, 0.75], every other parameter N(0, 0.1^2); BN
    running means N(0, 0.1^2), running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() > 1:
                v = randn(rng, *p.shape, scale=p[0].numel() ** -0.5)
            elif name.endswith("alpha"):
                v = 0.25 + 0.5 * rng.random(p.shape, np.float32)
            else:
                v = randn(rng, *p.shape, scale=0.1)
                if name.endswith("weight"):
                    v = v + 1.0
            p.copy_(t(v))
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(t(randn(rng, *b.shape, scale=0.1)))
            elif name.endswith("running_var"):
                b.copy_(t(0.5 + rng.random(b.shape, np.float32)))
    return module


def variables(module: torch.nn.Module, name: str | None = None) -> dict:
    """{'params', 'batch_stats'} of the port module through the JAX
    converter, at attribute `name` of a network (the key rewrite depends
    on it) or at the top."""
    sd = module.state_dict()
    if name is None:
        return split_batch_stats(convert_state_dict(sd))
    tree = convert_state_dict({f"{name}.{k}": v for k, v in sd.items()})
    return split_batch_stats(tree[name])


def _rel_l2(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape", [(1, 1, 1, 72), (2, 1, 1, 72),
                                   (2, 5, 6, 16)])
def test_batch_norm_matches_flax(shape):
    """Train mode at batch 1 (the pooled (1, 1, 1, C) input that
    torch.nn.BatchNorm2d refuses) and 2: the output and the updated
    statistics (momentum 0.99, the biased variance); then eval mode."""
    bn = trained_scale(ps.BatchNorm(shape[-1]), 1)
    x = randn(np.random.default_rng(2), *shape, scale=2.0) + 0.5
    v = variables(bn, "bn")
    jbn = fnn.BatchNorm(use_running_average=False)
    want, new = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    got = bn.train()(t(x))
    assert_close(got, want)
    assert_close(bn.running_mean, new["batch_stats"]["mean"], atol=1e-7)
    assert_close(bn.running_var, new["batch_stats"]["var"], atol=1e-7)
    assert int(bn.num_batches_tracked) == 1
    want = fnn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], **new}, jnp.asarray(x))
    assert_close(bn.eval()(t(x)), want)


@pytest.mark.parametrize("tlc", [None, 246, 210])
def test_pool_matches_jax(tlc):
    """The global mean, and TLC's local box pool at 20 x 24 (kernel 19 x
    23 at 246, 16 x 19 at 210: smaller than the image)."""
    x = randn(np.random.default_rng(3), 2, 20, 24, 8)
    assert_close(ps._pool(t(x), tlc), js._pool(jnp.asarray(x), tlc))


@pytest.mark.parametrize("tlc", [None, 246])
@pytest.mark.parametrize("kind", ["gap", "patchap", "sfconv"])
def test_frequency_module_matches_jax(kind, tlc):
    rng = np.random.default_rng(4)
    c = 8
    port, jm = {
        "gap": (lambda: ps.Gap(c, tlc), lambda: js.Gap(c, tlc)),
        "patchap": (lambda: ps.PatchAP(c, 2, tlc),
                    lambda: js.PatchAP(c, 2, tlc)),
        "sfconv": (lambda: ps.SFconv(c, tlc), lambda: js.SFconv(c, tlc)),
    }[kind]
    m = trained_scale(port(), 5)
    args = [randn(rng, 2, 16, 20, c) for _ in range(2 if kind == "sfconv"
                                                    else 1)]
    want = jm().apply(variables(m), *map(jnp.asarray, args))
    with torch.no_grad():
        assert_close(m(*map(t, args)), want)


@pytest.mark.parametrize("ks,c", [(3, 8), (5, 8), (3, 4), (5, 16)])
@pytest.mark.parametrize("train", [False, True])
def test_dynamic_filter_matches_jax(ks, c, train):
    """The channel-major unfold of the reflect-padded input, min(8, C)
    groups, the softmax over the taps; in train mode at batch 2 the BN
    statistics too."""
    m = trained_scale(ps.DynamicFilter(c, ks, tlc_base=246), 6)
    x = randn(np.random.default_rng(7), 2, 12, 10, c)
    jm = js.DynamicFilter(c, ks, tlc_base=246, use_running_average=not train)
    v = variables(m)
    if train:
        want, new = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        got = m.train()(t(x))
        assert_close(m.bn.running_mean, new["batch_stats"]["bn"]["mean"],
                     atol=1e-7)
        assert_close(m.bn.running_var, new["batch_stats"]["bn"]["var"],
                     atol=1e-7)
    else:
        want = jm.apply(v, jnp.asarray(x))
        got = m.eval()(t(x))
    assert_close(got.detach(), want)


@pytest.mark.parametrize("port,jax_module,name,c", [
    (lambda: ps.SFResBlock(16, True, 246),
     lambda: js.SFResBlock(16, True, 246), "layers_0", 16),
    (lambda: ps.SFResBlock(8, False), lambda: js.SFResBlock(8, False),
     "layers_0", 8),
    (lambda: ps.EBlockResFusion(16, 2), lambda: js.EBlockResFusion(16, 2),
     "masa_blk_enc_level1", 16),
    (lambda: ps.SCM(16), lambda: js.SCM(16), "SCM1", 3),
])
def test_block_matches_jax(port, jax_module, name, c):
    """Each block at a name of its network (the SCM's `main.4` rewrite
    needs the prefix), eval mode."""
    m = trained_scale(port(), 8).eval()
    x = randn(np.random.default_rng(9), 2, 12, 16, c)
    want = jax_module().apply(variables(m, name), jnp.asarray(x))
    with torch.no_grad():
        assert_close(m(t(x)), want)


def _net(kind, tlc, seed, dtype=torch.float32):
    if kind == "plain":
        m = ps.SFNet(**TINY, tlc_base=tlc, dtype=dtype)
        j = js.SFNet(**TINY, tlc_base=tlc)
    else:
        m = ps.SFNetRefFusion(**TINY_REF, tlc_base=tlc, dtype=dtype)
        j = js.SFNetRefFusion(**TINY_REF, tlc_base=tlc)
    return trained_scale(m, seed).eval(), j


@pytest.mark.parametrize("kind,tlc,hw,bound", [
    ("plain", None, (40, 48), 1e-5), ("plain", 210, (40, 48), 1e-5),
    ("ref", 246, (48, 64), 1e-5), ("ref", None, (36, 44), 3e-5)])
def test_network_matches_jax(kind, tlc, hw, bound):
    """f32, each scale to `bound` relative in L2 and 1e-4 elementwise.
    SFNet's padder, 4, leaves the quarter scale's 2 x 2 patches of PatchAP
    odd unless the size is a multiple of 8 (in JAX too), so it runs at 40
    x 48.  RefFusion at 48 x 64, and at 36 x 44, padded to 48 x 48 and
    each scale cropped back: there the MASA search meets the zero padding's
    blocks, whose scores tie in exact arithmetic and fall to either
    candidate by summation order, and the warp reaches the crop through the
    convs' halo (3e-5; 1e-7 in the last scale's L2 at 32 x 32)."""
    m, j = _net(kind, tlc, 10)
    rng = np.random.default_rng(11)
    h, w = hw
    x = rng.random((1, h, w, 3), np.float32)
    ref = rng.random((1, h, w, 3), np.float32)
    args = (x,) if kind == "plain" else (x, ref)
    want = jax.jit(j.apply)(variables(m), *map(jnp.asarray, args))
    with torch.no_grad():
        got = m(*map(t, args))
    assert [tuple(g.shape) for g in got] == [
        (1, h // 4, w // 4, 3), (1, h // 2, w // 2, 3), (1, h, w, 3)]
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= bound
        assert_close(g, w, atol=1e-4, rtol=0)


def test_refusion_bf16_matches_jax():
    """bf16 compute, f32 parameters: each scale within C3's 3% in L2."""
    m, j = _net("ref", 246, 12, torch.bfloat16)
    rng = np.random.default_rng(13)
    x, ref = (rng.random((1, 32, 32, 3), np.float32) for _ in range(2))
    want = jax.jit(j.clone(dtype=jnp.bfloat16).apply)(
        variables(m), jnp.asarray(x), jnp.asarray(ref))
    with torch.no_grad():
        got = m(t(x), t(ref))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, np.asarray(w.astype(jnp.float32))) <= 3e-2


def test_reference_checkpoint_loads_strict_and_matches_oracle(tmp_path):
    """The reference-layout torch oracle's state dict, with each dynamic
    filter's dead lamb_l / lamb_h added and DDP's `module.` prefix, loads
    into the port with strict=True (BN buffers included) and gives the
    oracle's three outputs."""
    om = trained_scale(OSFNetRefFusion(**TINY_REF), 14).eval()
    sd = om.state_dict()
    dead = {}
    for k in sd:
        if k.endswith(".bn.running_mean"):
            pre = k[: -len("bn.running_mean")]
            dead[pre + "lamb_l"] = torch.zeros(4)
            dead[pre + "lamb_h"] = torch.zeros(4)
    assert dead and any(".bn.num_batches_tracked" in k for k in sd)
    path = tmp_path / "net_g.pth"
    torch.save({"params": {f"module.{k}": v for k, v in {**sd, **dead}
                           .items()}}, path)
    m = load_reference_checkpoint(ps.SFNetRefFusion(**TINY_REF), str(path))
    for k, v in sd.items():
        assert torch.equal(m.state_dict()[k], v), k
    rng = np.random.default_rng(15)
    x, ref = (rng.random((1, 32, 32, 3), np.float32) for _ in range(2))
    with torch.no_grad():
        want = om(*(t(a).permute(0, 3, 1, 2) for a in (x, ref)))
        got = m.eval()(t(x), t(ref))
    for g, w in zip(got, want):
        assert_close(g, w.permute(0, 2, 3, 1).numpy(), atol=1e-4, rtol=0)


def test_jax_params_load_back():
    """load_jax_params with batch_stats inverts the JAX converter: the
    transposed convs' kernels unflipped, BN scale -> weight, mean / var ->
    running_mean / running_var."""
    m, _ = _net("ref", None, 16)
    v = variables(m)
    back = load_jax_params(ps.SFNetRefFusion(**TINY_REF), v["params"],
                           v["batch_stats"])
    for k, val in m.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[k], val), k
    with pytest.raises(KeyError, match="running_mean"):
        load_jax_params(ps.SFNetRefFusion(**TINY_REF), v["params"])


def test_define_network_builds_the_family():
    m = define_network({"type": "SFNetRefFusion", "num_res": 2,
                        "base_channel": 8, "nf": 8, "tlc_base": 210,
                        "ext_n_blocks": [1, 1, 1]}, dtype=torch.bfloat16)
    assert isinstance(m, ps.SFNetRefFusion) and not m.training
    assert m.dtype == torch.bfloat16 and m.tlc_base == 210
    assert len(m.Encoder[0].layers) == 2
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert isinstance(define_network({"type": "SFNet", "num_res": 1}),
                      ps.SFNet)
