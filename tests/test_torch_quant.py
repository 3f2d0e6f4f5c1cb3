"""The port's int8 frozen base (``adapters/quant.py``) against the JAX
package's ``adapters/quant.py``, on the CPU (fp32 unless stated):

* the int8 codes and scales of a tiny UNet carried across by the weight
  bridge are bit-equal to JAX ``quantize_params`` (from fp32 and from bf16
  weights), and the factory quantizes from the source precision (the fp32
  draw), as JAX's ``quantize_init`` does;
* the set of quantized modules equals JAX's rule at tiny width and at full
  SDXL, SD1.5 and SD2.1 width, from shapes alone (the port on the ``meta``
  device, JAX over ``jax.eval_shape`` of the init);
* one ``QuantLinear`` against JAX's interceptor (``make_quant_apply`` over a
  one-Dense module): within 1e-6 weight-only and W8A8, the activation codes
  and the int32 product bit-equal;
* a tiny-xl and a tiny-SD UNet forward under the int8 base within 2e-4 of
  JAX ``make_quant_apply``; with act-quant the bound is stated at the test;
* the LoRA sites over an int8 UNet, the merge's refusal and the act-quant
  refusal, word for word.

Tiny widths hold no Linear of 65,536 elements, so the tiny cases quantize
with ``min_elems=1`` in both packages (the JAX package's own tests do the
same)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.adapters import quant as jquant
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu.models import unet as junet
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import quant as tquant
from sliders_conceptmod_tpu_torch.io.jax_params import load_jax_params, to_jax_tree, to_numpy_tree
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models import unet as tunet
from test_torch_sd_train import _random_unet
from test_torch_train import CTX, SEQ, slice_setup  # noqa: F401 (fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

FWD_TOL = 2e-4


def _node(tree, path):
    for seg in path:
        tree = tree[seg]
    return tree


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _quantized_port(port: torch.nn.Module, qtree) -> torch.nn.Module:
    """The port's UNet over JAX's quantized tree: a shared copy of ``port``
    with JAX's int8 set quantized, every leaf from ``qtree``."""
    q = tquant.shared_copy(port)
    paths = {p[:-1] for p in _leaf_paths(qtree) if p[-1] == "kernel_scale"}
    tquant.quantize_module(q, paths=paths)
    assert load_jax_params(q, to_numpy_tree(qtree)) == []
    return q


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


# ---------------------------------------------------------------------------
# codes, scales and the quantized set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_scales_bit_equal_to_jax(slice_setup, dtype):
    _, params, port, *_ = slice_setup
    jparams = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), params)
    qtree, jscales = jquant.quantize_params(jparams, min_elems=1)
    tport = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl()).to(getattr(torch, dtype))
    load_jax_params(tport, to_numpy_tree(jparams))
    tscales = tquant.quantize_module(tport, min_elems=1)
    assert sorted(tscales) == sorted(jscales) and len(tscales) == 60
    tree = to_jax_tree(tport)
    for path in jscales:
        want, got = _node(qtree, path), _node(tree, path)
        assert got["kernel"].dtype == torch.int8 and got["kernel_scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["kernel"].numpy(), np.asarray(want["kernel"]))
        np.testing.assert_array_equal(_bits(got["kernel_scale"].numpy()), _bits(want["kernel_scale"]))
        np.testing.assert_array_equal(_bits(tscales[path].numpy()), _bits(jscales[path]))
    # every other leaf as it was (a quantized module keeps its bias)
    assert {p for p in _leaf_paths(tree)} == {p for p in _leaf_paths(qtree)}


def test_factory_quantizes_from_the_source_precision(monkeypatch):
    """``quantize_base`` at bf16 quantizes the fp32 draw (JAX's
    ``quantize_init``), not the bf16 cast: its codes are those of the fp32
    model, and the non-quantized leaves are the bf16 model's."""
    monkeypatch.setattr(tquant, "QUANT_MIN_ELEMS", 1)
    _, _, fp32, _ = tfactory.load_models_xl("tiny-xl", weight_dtype=torch.float32, device="cpu")
    _, _, bf16, _ = tfactory.load_models_xl("tiny-xl", weight_dtype=torch.bfloat16, device="cpu")
    _, _, q, _ = tfactory.load_models_xl("tiny-xl", weight_dtype=torch.bfloat16, device="cpu", quantize_base=True)
    from_fp32 = tquant.shared_copy(fp32)
    from_bf16 = tquant.shared_copy(bf16)
    tquant.quantize_module(from_fp32)
    tquant.quantize_module(from_bf16)
    got, want, cast = (dict(m.named_buffers()) for m in (q, from_fp32, from_bf16))
    assert set(got) == set(want) and len(got) == 120
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert any(not torch.equal(got[k], cast[k]) for k in got if k.endswith("weight_q"))
    plain = dict(bf16.named_parameters())
    assert all(torch.equal(t, plain[n]) for n, t in q.named_parameters())
    assert all(m.compute_dtype == torch.bfloat16 for m in q.modules() if isinstance(m, tquant.QuantLinear))


def _jax_init_shapes(cfg: junet.UNetConfig):
    added = None
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        added = {"text_embeds": jnp.zeros((1, pooled)), "time_ids": jnp.zeros((1, 6))}
    return jax.eval_shape(lambda: junet.UNet2DConditionModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)), jnp.zeros((1, 2, cfg.cross_attention_dim)),
        added_cond_kwargs=added))["params"]


@pytest.mark.parametrize("family,min_elems,count", [
    ("sdxl", None, 743), ("sd15", None, 184), ("sd21", None, 216), ("tiny", 1, 50), ("tiny_xl", 1, 60),
])
def test_quantized_set_matches_jax(family, min_elems, count):
    """The JAX rule (a 2-D ``kernel`` leaf of at least ``min_elems``
    elements) over the shapes of JAX's init, against the port's
    ``quantize_module`` on the meta device: SD1.5's 1×1 ``proj_in``/
    ``proj_out`` convolutions stay out, SDXL's linear ones and its time and
    ``add_embedding`` Linears come in."""
    limit = jquant.QUANT_MIN_ELEMS if min_elems is None else min_elems
    shapes = _jax_init_shapes(getattr(junet.UNetConfig, family)())
    want = {p[:-1] for p in _leaf_paths(shapes)
            if p[-1] == "kernel" and len(_node(shapes, p).shape) == 2 and _node(shapes, p).size >= limit}
    with torch.device("meta"):
        port = tunet.UNet2DConditionModel(getattr(tunet.UNetConfig, family)())
        got = set(tquant.quantize_module(port, min_elems=min_elems))
    assert got == want and len(got) == count
    if family == "sdxl":
        assert {("add_embedding", "linear_1"), ("time_embedding", "linear_1"),
                ("down_blocks_1", "attentions_0", "proj_in")} <= got
    if family == "sd15":
        assert ("down_blocks_0", "attentions_0", "proj_in") not in got
        assert ("time_embedding", "linear_1") in got
    by_path = {tlora.module_path(n): m for n, m in port.named_modules()}
    assert all(isinstance(by_path[p], tquant.QuantLinear) for p in got)


# ---------------------------------------------------------------------------
# one QuantLinear against JAX's interceptor
# ---------------------------------------------------------------------------


class _OneDense(fnn.Module):
    features: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(self.features, name="proj", dtype=jnp.float32)(x)


@pytest.mark.parametrize("lead", [(3,), (2, 5)], ids=["rows", "tokens"])
@pytest.mark.parametrize("act_quant", [False, True], ids=["weight_only", "w8a8"])
def test_quant_linear_matches_jax_interceptor(lead, act_quant):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(lead + (48,)).astype(np.float32)
    model = _OneDense(40)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 48)))["params"]
    params = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), params)
    qtree, scales = jquant.quantize_params(params, min_elems=1)
    want = np.asarray(jquant.make_quant_apply(model, scales, jnp.float32, act_quant=act_quant)(qtree, jnp.asarray(x)))

    mod = tquant.QuantLinear(48, 40, compute_dtype=torch.float32, act_quant=act_quant)
    with torch.no_grad():
        mod.weight_q.copy_(torch.from_numpy(np.asarray(qtree["proj"]["kernel"]).T))
        mod.scale.copy_(torch.from_numpy(np.asarray(qtree["proj"]["kernel_scale"])))
        mod.bias.copy_(torch.from_numpy(np.asarray(qtree["proj"]["bias"])))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    # W8A8's pieces bit for bit: the per-token codes and scales, the int32 product
    jxq, jsx = jquant.quantize_activations(jnp.asarray(x))
    txq, tsx = tquant.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(_bits(tsx.numpy()), _bits(jsx))
    prod = tquant.int8_matmul(txq, mod.weight_q)
    assert prod.dtype == torch.int32
    np.testing.assert_array_equal(prod.numpy(), np.asarray(jquant.int8_matmul(jxq, qtree["proj"]["kernel"])))


def test_quant_linear_backward_reaches_the_input_only():
    """The weight-only backward, rebuilt from the int8 codes, equals autograd
    through ``F.linear`` of the dequantized weight; nothing of the base
    takes a gradient."""
    rng = np.random.default_rng(4)
    lin = torch.nn.Linear(24, 16)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32)))
    mod = tquant.QuantLinear.from_linear(lin.requires_grad_(False))
    x = torch.from_numpy(rng.standard_normal((2, 7, 24)).astype(np.float32)).requires_grad_(True)
    (mod(x) ** 2).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    w = tquant.dequantize(mod.weight_q, mod.scale)
    ((torch.nn.functional.linear(x2, w) + lin.bias) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)
    assert mod.bias is lin.bias and not any(t.requires_grad for t in mod.parameters())


# ---------------------------------------------------------------------------
# tiny UNet forwards
# ---------------------------------------------------------------------------


def _xl_inputs(rng, n):
    return dict(
        sample=rng.standard_normal((n, 4, 8, 8)).astype(np.float32),
        t=np.asarray([17.0, 503.0][:n], np.float32),
        ctx=rng.standard_normal((n, SEQ, CTX)).astype(np.float32),
        added={"text_embeds": rng.standard_normal((n, 32)).astype(np.float32),
               "time_ids": np.tile(np.asarray([[64, 64, 0, 0, 64, 64]], np.float32), (n, 1))},
    )


@pytest.mark.parametrize("family", ["tiny_xl", "tiny"])
@pytest.mark.parametrize("act_quant", [False, True], ids=["weight_only", "w8a8"])
def test_tiny_unet_forward_matches_make_quant_apply(slice_setup, family, act_quant):
    """Within 2e-4 of JAX, weight-only and W8A8. Under W8A8 the activation
    codes are re-derived at every Linear from inputs that differ between the
    packages by fp32 rounding (~1e-7), so a value within that of a rounding
    midpoint could take the neighbouring code in one package; no code flips
    on these inputs (measured gap ≤ 6e-7 of the output's largest value)."""
    if family == "tiny_xl":
        model, params, port, *_ = slice_setup
    else:
        model, params, port = _random_unet("tiny", seed=1)
    qtree, scales = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_elems=1)
    q = _quantized_port(port, qtree)
    tquant.set_act_quant(q, act_quant)
    inp = _xl_inputs(np.random.default_rng(5), 2)
    added = inp["added"] if family == "tiny_xl" else None
    want = np.asarray(jquant.make_quant_apply(model, scales, jnp.float32, act_quant=act_quant)(
        qtree, jnp.asarray(inp["sample"]), jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"]),
        added_cond_kwargs=None if added is None else {k: jnp.asarray(v) for k, v in added.items()}))
    with torch.no_grad():
        got = q(torch.from_numpy(inp["sample"]), torch.from_numpy(inp["t"]), torch.from_numpy(inp["ctx"]),
                added_cond_kwargs=None if added is None else {k: torch.from_numpy(v) for k, v in added.items()})
    scale = np.abs(want).max()
    gap = np.abs(got.numpy() - want).max() / scale
    print(f"{family} act_quant={act_quant}: max gap {gap:.3g} of max |out| {scale:.3g}")
    assert gap <= FWD_TOL


# ---------------------------------------------------------------------------
# sites and refusals
# ---------------------------------------------------------------------------


def test_sites_merge_refusal_and_act_quant_refusal_match_jax(slice_setup):
    _, params, port, jsites, jlp, tsites, *_ = slice_setup
    qtree, _ = jquant.quantize_params(jax.tree.map(jnp.asarray, params), min_elems=1)
    q = _quantized_port(port, qtree)
    # an int8 UNet has the full-precision UNet's sites: names, kinds, dims, order
    assert tlora.create_sites(q, rank=2, alpha=1.0, train_method="full") == tsites
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    with pytest.raises(ValueError) as want:
        jlora.merge_lora_params(qtree, jsites, jlp, 1.0)
    with pytest.raises(ValueError) as got:
        tlora.merge_lora_params(q, tsites, tlp, 1.0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        with tlora.merged_weights(q, {"down_blocks.1.attentions.0.proj_in.weight": torch.zeros(1)}):
            pass
    assert "cannot merge LoRA into integer (quantized) kernel at down_blocks_1/attentions_0/proj_in" in str(got.value)

    _, _, junet_b, _ = jfactory.load_models_xl("tiny-xl")
    with pytest.raises(ValueError) as want:
        junet_b.apply_fn(act_quant=True)
    with pytest.raises(ValueError) as got:
        tquant.set_act_quant(port, True)
    assert str(got.value) == str(want.value)
    tquant.set_act_quant(port, False)  # switching it off an unquantized UNet is a no-op, as in JAX


def test_shared_and_quantized_copies_share_tensors(slice_setup):
    """The dual tree's int8 copy shares every tensor it does not quantize
    with the base (JAX's tree shares them by reference); the act-quant view
    of an int8 base shares them all."""
    port = slice_setup[2]
    warm = tquant.quantized_copy(port, act_quant=True, min_elems=1)
    base = dict(port.named_parameters())
    for name, p in warm.named_parameters():
        assert p is base[name], name
    quantized = {n for n, m in warm.named_modules() if isinstance(m, tquant.QuantLinear)}
    assert len(quantized) == 60 and all(warm.get_submodule(n).act_quant for n in quantized)
    assert not any(isinstance(m, tquant.QuantLinear) for m in port.modules())
    view = tquant.quantized_copy(warm, act_quant=False)
    assert all(a is b for a, b in zip(view.buffers(), warm.buffers()))
    assert all(warm.get_submodule(n).act_quant and not view.get_submodule(n).act_quant for n in quantized)
