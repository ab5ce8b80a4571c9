"""The port's CoCa slice against the JAX package, on the CPU: the model
(attentional pooler, ``embed_cls`` text tower, multimodal decoder), its
loss and gradients, caption generation (top-k, top-p, grouped beam
search), the BPE decode, the block routes, and ``cli.main`` training a
toy CoCa (mirrors tests/test_coca.py).

Toy geometry: vision width 96 with 3 heads of 32, 2 layers, patch 8,
32 px (L = 17), an attentional pooler of 8 queries and 4 heads at the
embed dim 64, so its key/value width (96) is not its own (separate
q/k/v projections); text and decoder width 64, 4 heads, 2 layers each,
context 12 (13 positions with the class token), a vocabulary of 200 ids
whose last two stand in for SOT and EOT. Weights cross through
``load_jax_params`` (strict: every parameter name must match JAX's tree).

Bars (BASELINE.md:18, fp32): features, logits and losses within 1e-3;
each gradient within 1e-3 normalized by its largest JAX value;
generated tokens and decoded text equal. bf16 blocks against JAX's: one
bf16 ULP at output scale (atol = max|ref| / 128, rtol = 1e-2). The
kernels at CoCa's shapes on the card are tests/test_torch_kernels.py's
(that file runs where the card is, without JAX).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xtagclip_tpu.factory import add_model_config as jax_add_model_config
from xtagclip_tpu.factory import create_model as jax_create_model
from xtagclip_tpu.losses.coca import CoCaLoss as JCoCaLoss
from xtagclip_tpu.models import coca as jcoca
from xtagclip_tpu.models.layers import AttentionalPooler as JPooler
from xtagclip_tpu.models.layers import ResidualAttentionBlock as JBlock
from xtagclip_tpu.models.text import build_causal_mask as j_causal
from xtagclip_tpu.tokenize import bpe as jbpe
from xtagclip_tpu.train.loop import _model_losses as j_model_losses
from xtagclip_tpu.train.loop import make_accum_train_step as j_accum_step
from xtagclip_tpu_torch import factory
from xtagclip_tpu_torch.cli import main as port_main
from xtagclip_tpu_torch.convert.export import to_openclip_state_dict
from xtagclip_tpu_torch.convert.from_jax import load_jax_params, port_name
from xtagclip_tpu_torch.losses import CoCaLoss
from xtagclip_tpu_torch.models import coca
from xtagclip_tpu_torch.models.layers import (
    AttentionalPooler,
    ResidualAttentionBlock,
)
from xtagclip_tpu_torch.models.text import build_causal_mask
from xtagclip_tpu_torch.ops import fused_attn_block as fab
from xtagclip_tpu_torch.ops import fused_mlp
from xtagclip_tpu_torch.tokenize import bpe
from xtagclip_tpu_torch.train.logger import close_logging
from xtagclip_tpu_torch.train.loop import _model_losses, make_accum_train_step
from torch_tmp import remove_module_tmp, remove_test_tmp  # noqa: E402,F401

torch.set_num_threads(1)

VOCAB, CTX, SOT, EOT = 200, 12, 198, 199
CFG = dict(
    embed_dim=64,
    vision_cfg=dict(layers=2, width=96, head_width=32, patch_size=8,
                    image_size=32, attentional_pool=True,
                    attn_pooler_queries=8, attn_pooler_heads=4),
    text_cfg=dict(context_length=CTX, vocab_size=VOCAB, width=64, heads=4,
                  layers=2, embed_cls=True, output_tokens=True),
    multimodal_cfg=dict(context_length=CTX, vocab_size=VOCAB, width=64,
                        heads=4, layers=2),
)
TOL = dict(rtol=1e-3, atol=1e-3)
COCA_ARGS = {"coca": True, "coca_caption_loss_weight": 2.0,
             "coca_contrastive_loss_weight": 1.0}
B = 3


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_ulp_bar(out, ref):
    out, ref = _np(out), _np(ref)
    np.testing.assert_allclose(out, ref, atol=float(np.abs(ref).max()) / 128,
                               rtol=1e-2)


@pytest.fixture(scope="module")
def cfg_name(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "torch-tinycoca.json"
    path.write_text(json.dumps(CFG))
    jax_add_model_config(str(path))
    factory.add_model_config(path)
    return path.stem


@pytest.fixture(scope="module")
def pair(cfg_name):
    """(JAX bundle, port model with the bundle's weights), both fp32."""
    bundle = jax_create_model(cfg_name)
    model = factory.create_model(cfg_name, device="cpu", init_seed=1)
    load_jax_params(model, jax.tree.map(np.asarray, bundle.params))
    return bundle, model


def _batch(seed=0, b=B):
    """Images and SOT ... EOT captions of different lengths with pad tails
    (pad id 0)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    texts = np.zeros((b, CTX), np.int32)
    for i, n in enumerate(rng.integers(2, CTX - 1, b)):
        texts[i, 0] = SOT
        texts[i, 1:n + 1] = rng.integers(1, SOT, n)
        texts[i, n + 1] = EOT
    return images, texts


def test_tree_names_match_jax(pair):
    """load_jax_params is strict; CoCa's own leaves are among the names."""
    _, model = pair
    names = dict(model.named_parameters())
    for n in ("text.cls_emb", "visual.attn_pool.query",
              "visual.attn_pool.ln_q.scale", "visual.attn_pool.ln_k.scale",
              "visual.attn_pool.attn.q_proj.kernel",
              "visual.attn_pool.attn.k_proj.kernel",
              "visual.attn_pool.attn.v_proj.kernel",
              "visual.attn_pool.attn.out_proj.kernel",
              "text_decoder.cross_attn.1.ln_1_kv.scale",
              "text_decoder.resblocks.1.attn.in_proj.kernel",
              "text_decoder.text_projection", "text_decoder.ln_final.bias"):
        assert n in names, n
    assert port_name("text_decoder.cross_attn_1.ln_1_kv.scale") == \
        "text_decoder.cross_attn.1.ln_1_kv.scale"
    assert tuple(names["text.positional_embedding"].shape) == (CTX + 1, 64)
    assert tuple(names["text_decoder.text_projection"].shape) == (64, VOCAB)


def test_forward_matches_jax(pair):
    bundle, model = pair
    images, texts = _batch()
    ref = bundle.apply(jnp.asarray(images), jnp.asarray(texts))
    with torch.inference_mode():
        out = model(torch.from_numpy(images), torch.from_numpy(texts))
    assert tuple(out["logits"].shape) == (B, CTX - 1, VOCAB)
    assert out["logits"].dtype == torch.float32
    for k in ("image_features", "text_features", "logits", "logit_scale"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(ref["labels"]))


def test_embed_cls_pooled_and_tokens_match_jax(pair):
    """The class token's ln_final'd row (pooled, before the projection)
    and the other rows (no ln_final), on texts with pad tails."""
    bundle, model = pair
    _, texts = _batch(1)
    j_proj, j_tok = bundle.module.apply(
        {"params": bundle.params}, jnp.asarray(texts),
        method=lambda m, t: m.text(t))
    with torch.inference_mode():
        proj, tok = model.text(torch.from_numpy(texts))
    assert tuple(tok.shape) == (B, CTX, 64)
    np.testing.assert_allclose(_np(proj), np.asarray(j_proj), **TOL)
    np.testing.assert_allclose(_np(tok), np.asarray(j_tok), **TOL)


def test_attentional_pooler_with_other_key_width_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 17, 96)).astype(np.float32)
    jp = JPooler(d_model=64, context_dim=96, n_head=4, n_queries=8)
    params = jax.jit(jp.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    assert set(params["attn"]) == {"q_proj", "k_proj", "v_proj", "out_proj"}
    ref = jax.jit(jp.apply)({"params": params}, jnp.asarray(x))
    pooler = AttentionalPooler(64, 96, n_head=4, n_queries=8)
    load_jax_params(pooler, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        out = pooler(torch.from_numpy(x))
    assert tuple(out.shape) == (2, 8, 64)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_coca_loss_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((B, 16)).astype(np.float32)
    txt = rng.standard_normal((B, 16)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    logits = rng.standard_normal((B, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(1, 50, (B, 7)).astype(np.int32)
    labels[0, 4:] = 0
    labels[2, 2:] = 0
    for cw, kw in ((2.0, 1.0), (1.0, 0.0)):
        ref = JCoCaLoss(caption_loss_weight=cw, clip_loss_weight=kw)(
            jnp.asarray(img), jnp.asarray(txt), jnp.asarray(logits),
            jnp.asarray(labels), jnp.float32(14.3), output_dict=True)
        out = CoCaLoss(caption_loss_weight=cw, clip_loss_weight=kw)(
            *map(torch.from_numpy, (img, txt, logits, labels)),
            torch.tensor(14.3), output_dict=True)
        for k in ("contrastive_loss", "caption_loss"):
            np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]),
                                       **TOL, err_msg=k)
    # every label a pad: the caption term's denominator is clamped at 1
    zero = CoCaLoss(1.0, 0.0)(*map(torch.from_numpy, (
        img, txt, logits, np.zeros_like(labels))), torch.tensor(1.0))
    assert zero[1].item() == 0.0


def test_loss_and_grads_match_jax(pair):
    """The whole CoCa train objective (contrastive + 2 x caption) and
    every gradient against jax.grad of JAX's ``_model_losses``."""
    bundle, model = pair
    images, texts = _batch(5)

    def j_total(params):
        return j_model_losses(bundle.module, params, {
            "images": jnp.asarray(images), "texts": jnp.asarray(texts)},
            {"dropout": jax.random.PRNGKey(0)}, COCA_ARGS, None)

    (j_val, (j_metrics, _)), j_grads = jax.jit(
        jax.value_and_grad(j_total, has_aux=True))(bundle.params)
    model.zero_grad(set_to_none=True)
    total, metrics = _model_losses(
        model, {"images": torch.from_numpy(images),
                "texts": torch.from_numpy(texts)}, COCA_ARGS,
        generator=torch.Generator().manual_seed(0))
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_val), **TOL)
    for k in ("contrastive_loss", "caption_loss", "logit_scale"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   **TOL, err_msg=k)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for path, g in jax.tree_util.tree_leaves_with_path(j_grads):
        name = port_name(".".join(str(k.key) for k in path))
        g = np.asarray(g)
        err = np.abs(_np(grads[name]) - g).max() / max(1.0, np.abs(g).max())
        assert err <= 1e-3, (name, err)
    model.zero_grad(set_to_none=True)


def test_accum_step_refuses_coca_as_jax_raises(pair):
    """JAX's accumulation step calls the model with the XTag keywords,
    which CoCa's ``__call__`` does not take: TypeError at the first step.
    The port's refuses CoCa when it is made."""
    from xtagclip_tpu.train.scheduler import cosine_lr
    from xtagclip_tpu.train.train_state import (
        create_train_state,
        make_optimizer,
    )

    bundle, _ = pair
    images, texts = _batch(6, b=4)
    tx = make_optimizer(cosine_lr(1e-3, 2, 50), params=bundle.params)
    step = j_accum_step(bundle.module, tx, COCA_ARGS, 2, donate=False)
    with pytest.raises(TypeError, match="prompt_table"):
        step(create_train_state(bundle.params, tx), {
            "images": images.reshape(2, 2, 32, 32, 3),
            "texts": texts.reshape(2, 2, CTX)}, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="CoCa"):
        make_accum_train_step(COCA_ARGS, 2)


# -- generation ----------------------------------------------------------------

GEN_CASES = {
    "top_k": dict(generation_type="top_k", top_k=1, min_seq_len=3),
    "top_k_repetition": dict(generation_type="top_k", top_k=1,
                             repetition_penalty=1.5, min_seq_len=2),
    "top_k_fixed": dict(generation_type="top_k", top_k=1, min_seq_len=2,
                        fixed_output_length=True, seq_len=10),
    "top_p": dict(generation_type="top_p", top_p=0.9, seed=7,
                  temperature=0.7),
    "beam": dict(generation_type="beam_search", num_beams=6,
                 num_beam_groups=3, min_seq_len=3),
    "beam_diverse_fixed": dict(generation_type="beam_search", num_beams=4,
                               num_beam_groups=2, diversity_penalty=1.0,
                               min_seq_len=2, fixed_output_length=True,
                               seq_len=10),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generate_matches_jax(pair, case):
    bundle, model = pair
    images, _ = _batch(8, b=2)
    kw = dict(seq_len=8, max_seq_len=CTX, sot_token_id=SOT,
              eos_token_id=EOT)
    kw.update(GEN_CASES[case])
    ref = jcoca.generate(bundle.module, bundle.params, jnp.asarray(images),
                         **kw)
    out = coca.generate(model, torch.from_numpy(images), **kw)
    assert out.dtype == np.int32 and (out[:, 0] == SOT).all()
    if kw.get("fixed_output_length"):
        assert out.shape == (2, kw["seq_len"])
    np.testing.assert_array_equal(out, ref)


def test_beam_groups_must_divide_beams(pair):
    _, model = pair
    with pytest.raises(ValueError, match="divisible"):
        coca.generate(model, torch.zeros((1, 32, 32, 3)),
                      generation_type="beam_search", num_beams=5,
                      num_beam_groups=3)


def test_top_p_filter_matches_jax():
    rng = np.random.default_rng(9)
    for top_p in (1e-9, 0.1, 0.5, 0.9, 0.999):
        logits = (rng.standard_normal((6, 300)) * 2).astype(np.float32)
        np.testing.assert_array_equal(coca.top_p_filter(logits, top_p),
                                      jcoca.top_p_filter(logits, top_p))


def test_decode_matches_jax_on_every_scar_prompt():
    """Every scar pseudo-prompt (3 classes x 2304 tag combinations, the
    sentence_1 template) tokenized, then decoded by both packages."""
    from xtagclip_tpu_torch.tokenize.prompts import PromptTable
    from xtagclip_tpu_torch.train import metadata

    tok = bpe.SimpleTokenizer()
    table = PromptTable(metadata.SCAR_CLASSNAMES, tokenizer=tok,
                        templates=["sentence_1"]).table.reshape(-1, 77)
    jtok = jbpe.SimpleTokenizer()
    for row in table:
        ids = row[:int(np.argmax(row == tok.eot_token_id)) + 1]
        text = tok.decode(ids)
        assert text == jtok.decode(ids)
        assert text.startswith("<start_of_text>")
    assert bpe.decode(table[0][:5]) == jbpe.decode(table[0][:5])


# -- blocks and routes -----------------------------------------------------------

def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_block_params(jblk, seed, *args, **kw):
    params = jax.jit(lambda *a: jblk.init(jax.random.PRNGKey(0), *a, **kw))(
        *args)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (1.0 if p[-1].key == "scale" else 0.0)
        + (rng.standard_normal(a.shape) * 0.1).astype(np.float32), params)


def test_decoder_self_attention_block_matches_jax_bf16():
    """One bf16 decoder self-attention block (width 128, 2 heads of 64,
    L = 75 under CoCa's causal mask): the port's fused halves (their plain
    versions on the CPU) against JAX's block on its Pallas fused half
    (XTAG_FUSED_BLOCK=1, TPU interpret mode, jitted: eager interpret mode
    can deadlock)."""
    from jax.experimental.pallas import tpu as pltpu

    x = _rng_arrays(11, (2, 75, 128))[0]
    xb = jnp.asarray(x, jnp.bfloat16)
    mask = j_causal(76)[:75, :75]
    jblk = JBlock(num_heads=2, dtype=jnp.bfloat16)
    params = _jax_block_params(jblk, 12, xb, attn_mask=mask)
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setenv("XTAG_FUSED_BLOCK", "1")
        ref = jax.jit(lambda p, a: jblk.apply({"params": p}, a,
                                              attn_mask=mask))(params, xb)
    blk = ResidualAttentionBlock(128, 2)
    load_jax_params(blk, jax.tree.map(np.asarray, params))
    tmask = build_causal_mask(76)[:75, :75].contiguous()
    assert blk.route(x.shape, tmask) == "fused_halves"
    with torch.inference_mode():
        out = blk(torch.from_numpy(x).bfloat16(), attn_mask=tmask)
    assert out.dtype == torch.bfloat16
    _assert_ulp_bar(out, ref)


def test_cross_attention_block_matches_jax_bf16():
    """One bf16 cross-attention block (queries width 128, image embeddings
    width 96, so ``ln_1_kv`` and separate q/k/v projections): the plain
    core and the MLP half (#2's plain version) against JAX's XLA block."""
    x, kv = _rng_arrays(13, (2, 30, 128), (2, 17, 96))
    xb, kvb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    jblk = JBlock(num_heads=2, is_cross_attention=True, dtype=jnp.bfloat16)
    params = _jax_block_params(jblk, 14, xb, k_x=kvb, v_x=kvb)
    ref = jax.jit(lambda p, a, b: jblk.apply({"params": p}, a, k_x=b,
                                             v_x=b))(params, xb, kvb)
    blk = ResidualAttentionBlock(128, 2, is_cross_attention=True,
                                 kv_width=96)
    load_jax_params(blk, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        out = blk(torch.from_numpy(x).bfloat16(),
                  kv=torch.from_numpy(kv).bfloat16())
    _assert_ulp_bar(out, ref)


def test_masked_text_block_matches_jax_bf16():
    """One bf16 text block under a per-sample [B, 1, L, L] mask (causal
    plus padded keys, as the ``embed_cls`` tower builds it) against JAX's
    XLA block."""
    x = _rng_arrays(15, (2, 13, 128))[0]
    pad = np.zeros((2, 13), bool)
    pad[0, 7:12] = True
    mask = (np.triu(np.full((13, 13), -np.inf, np.float32), 1)[None, None]
            + np.where(pad, -np.inf, 0.0).astype(np.float32)[:, None, None])
    xb = jnp.asarray(x, jnp.bfloat16)
    jblk = JBlock(num_heads=2, dtype=jnp.bfloat16)
    params = _jax_block_params(jblk, 16, xb, attn_mask=jnp.asarray(mask))
    ref = jax.jit(lambda p, a, m: jblk.apply({"params": p}, a, attn_mask=m))(
        params, xb, jnp.asarray(mask))
    blk = ResidualAttentionBlock(128, 2)
    load_jax_params(blk, jax.tree.map(np.asarray, params))
    tmask = torch.from_numpy(mask)
    assert blk.route(x.shape, tmask) == "plain_core"
    with torch.inference_mode():
        out = blk(torch.from_numpy(x).bfloat16(), attn_mask=tmask)
    _assert_ulp_bar(out, ref)


@pytest.mark.parametrize("what,l,d,heads,mask,cross,route", [
    # coca_ViT-L-14's streams: the decoder's causal self-attention
    # (training, generation), its cross-attention, the masked text tower
    # (training, generation), the ViT-L/14 vision tower
    ("decoder", 75, 768, 12, "causal", False, "fused_halves"),
    ("decoder generation", 30, 768, 12, "causal", False, "fused_halves"),
    ("cross-attention", 75, 768, 12, None, True, "plain_core"),
    ("text", 77, 768, 12, "per-sample", False, "plain_core"),
    ("text generation", 31, 768, 12, "per-sample", False, "plain_core"),
    ("vision", 257, 1024, 16, None, False, "non_fused"),
])
def test_coca_routes_are_chosen_by_shape_and_mask_rank(what, l, d, heads,
                                                       mask, cross, route):
    blk = ResidualAttentionBlock(d, heads, is_cross_attention=cross)
    m = {None: None, "causal": torch.zeros((l, l)),
         "per-sample": torch.zeros((2, 1, l, l))}[mask]
    assert blk.route((2, l, d), m) == route, what


def test_plain_core_route_runs_the_mlp_half_kernel_wrapper(monkeypatch):
    """bf16 streams of the plain-core route send their MLP half to #2's
    wrapper (its plain version on the CPU) where it takes the rows, and
    to #4's otherwise; the core never reaches a kernel wrapper."""
    calls = []
    for mod, name in ((fab, "fused_attn_half"), (fab, "fused_mlp_half"),
                      (fused_mlp, "fused_mlp")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    x, kv = (torch.from_numpy(a).bfloat16()
             for a in _rng_arrays(17, (2, 9, 128), (2, 5, 64)))
    blk = ResidualAttentionBlock(128, 2, is_cross_attention=True,
                                 kv_width=64)
    factory.init_params(blk, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        blk(x, kv=kv)
    assert calls == ["fused_mlp_half"]
    calls.clear()
    ls = ResidualAttentionBlock(128, 2, ls_init_value=0.1,
                                is_cross_attention=True, kv_width=64)
    factory.init_params(ls, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ls(x, kv=kv)
    assert calls == ["fused_mlp"]


def test_plain_core_raises_off_the_cpu_without_an_mlp_kernel():
    """A bf16 stream whose MLP no kernel takes (width 100: #4 takes
    multiples of 8, #2 of 64) raises on a device that is not the CPU (meta
    stands in for the card); the MLP half of a width the kernels take
    reaches #2's wrapper there."""
    blk = ResidualAttentionBlock(100, 2, is_cross_attention=True)
    x = torch.empty((1, 8, 100), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for MLP rows"):
        blk(x, kv=x)
    with torch.device("meta"):
        blk = ResidualAttentionBlock(128, 2, is_cross_attention=True)
    x = torch.empty((1, 8, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        blk(x, kv=x)


def test_export_refuses_coca(pair):
    """The port refuses where JAX's exporter writes a partial file: it
    drops every ``text_decoder`` and ``visual/attn_pool`` leaf."""
    from xtagclip_tpu.convert.export import to_openclip_state_dict as j_sd

    bundle, model = pair
    with pytest.raises(NotImplementedError, match="export.py:154"):
        to_openclip_state_dict(model)
    leaves = {".".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_leaves_with_path(bundle.params)}
    dropped = {n for n in leaves if n.startswith(("text_decoder.",
                                                  "visual.attn_pool."))}
    assert len(j_sd(bundle.params)) == len(leaves) - len(dropped)
    assert not any("decoder" in k or "attn_pool" in k
                   for k in j_sd(bundle.params))


def test_evaluate_runs_on_coca_where_jax_raises(pair):
    """JAX's ``evaluate`` unpacks ``encode_image``'s return into (image,
    tokens), but CoCa's returns the latent alone: ValueError for a batch
    other than 2. The port's CoCa returns (latent, tokens), as its CLIP
    does, and its val loss is JAX's formula on the same features."""
    import types

    from xtagclip_tpu.train.evaluate import evaluate as j_evaluate
    from xtagclip_tpu_torch.train.evaluate import val_features

    bundle, model = pair
    images, texts = _batch(10, b=4)
    args = types.SimpleNamespace(val_frequency=1, epochs=1,
                                 checkpoint_path=None)
    j_data = {"val": types.SimpleNamespace(dataloader=[(images, texts)])}
    with pytest.raises(ValueError, match="unpack"):
        j_evaluate(bundle.module, bundle.params, j_data, 1, args)
    u8 = np.zeros((4, 32, 32, 3), np.uint8)
    img, txt, scale, loss, n = val_features(
        model, [(torch.from_numpy(u8), torch.from_numpy(texts))])
    assert img.shape == (4, 64) and txt.shape == (4, 64) and n == 4
    assert np.isfinite(loss)


def test_bf16_model_keeps_layer_norms_and_block_biases_fp32(cfg_name):
    model = factory.create_model(cfg_name, device="cpu", precision="bf16")
    factory.cast_for_compute(model, torch.bfloat16)
    named = dict(model.named_parameters())
    for n in ("visual.attn_pool.ln_k.scale",
              "text_decoder.cross_attn.0.ln_1_kv.bias",
              "text_decoder.cross_attn.0.attn.in_proj.bias",
              "text_decoder.resblocks.0.mlp.c_fc.bias", "logit_scale"):
        assert named[n].dtype == torch.float32, n
    for n in ("text.cls_emb", "visual.attn_pool.query",
              "text_decoder.text_projection",
              "visual.attn_pool.attn.q_proj.bias"):
        assert named[n].dtype == torch.bfloat16, n
    images, texts = _batch(2)
    with torch.inference_mode():
        out = model(torch.from_numpy(images), torch.from_numpy(texts))
    assert out["logits"].dtype == torch.float32
    assert torch.isfinite(out["logits"]).all()


def test_factory_tokenize_cfg_and_loss(pair):
    from xtagclip_tpu.factory import get_model_tokenize_cfg as j_tok_cfg
    from xtagclip_tpu_torch.train.params import parse_args

    bundle, model = pair
    assert factory.get_model_tokenize_cfg(model) == j_tok_cfg(bundle)
    real = factory.create_model("coca_ViT-L-14", device="meta",
                                skip_init=True)
    assert factory.get_model_tokenize_cfg(real) == {"context_length": 76,
                                                    "vocab_size": 49408}
    assert sum(p.numel() for p in real.parameters()) == 638_450_177
    loss = factory.create_loss(parse_args([
        "--model", "coca_ViT-L-14", "--coca-contrastive-loss-weight", "0",
        "--coca-caption-loss-weight", "1"]))
    assert (loss.clip_loss_weight, loss.caption_loss_weight) == (0.0, 1.0)
    # SigLIP and distillation are ported (their slice): JAX's order
    for flags, kind in ((["--siglip"], "SigLipLoss"),
                        (["--distill-model", "RN50"], "DistillClipLoss")):
        loss = factory.create_loss(parse_args(["--model", "ViT-B-32", *flags]))
        assert type(loss).__name__ == kind


# -- the training CLI --------------------------------------------------------------

def test_cli_trains_and_evaluates_coca(tmp_path):
    """tests/test_coca.py::test_coca_cli_synthetic through the port's
    ``cli.main`` on the CPU, with a val split so ``evaluate`` runs on
    CoCa's outputs; the caption and contrastive terms are logged. The
    synthetic captions are BPE ids, so the toy model takes the real
    vocabulary here."""
    cfg = json.loads(json.dumps(CFG))
    cfg["text_cfg"]["vocab_size"] = cfg["multimodal_cfg"]["vocab_size"] = \
        49408
    path = tmp_path / "torch-tinycoca-cli.json"
    path.write_text(json.dumps(cfg))
    factory.add_model_config(path)
    try:
        out = port_main.main([
            "--model", path.stem, "--dataset-type", "synthetic",
            "--train-num-samples", "8", "--batch-size", "4", "--epochs",
            "1", "--warmup", "1", "--precision", "fp32", "--lr", "1e-4",
            "--logs", str(tmp_path / "logs"), "--name", "coca_e2e",
            "--log-every-n-steps", "1", "--val-data", "synthetic",
            "--val-num-samples", "8", "--workers", "1", "--device", "cpu"])
    finally:
        close_logging()
    assert (tmp_path / "logs" / "coca_e2e" / "checkpoints" /
            "epoch_1").is_dir()
    rec = out["epochs"][0]
    for k in ("loss", "caption_loss", "contrastive_loss"):
        assert np.isfinite(rec["train"][k]), k
    assert rec["eval"]["num_samples"] == 8
    assert np.isfinite(rec["eval"]["clip_val_loss"])
