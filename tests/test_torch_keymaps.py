"""The port's HF loaders (``io.keymaps``) on checkpoints in the real
layouts: transformers' Llama, CLIP and T5 written by ``save_pretrained``,
and diffusers' FluxTransformer2DModel and AutoencoderKL written key by key
(diffusers is not installed here).  Each loader is held to what the JAX
loaders' tests hold them to (tests/test_real_checkpoint.py,
tests/test_t5_vae_loaders.py, tests/test_flux_keymap.py):

* unquantized, the forward within 2e-3 of max |output| of transformers';
* int8, the normalized squared error within 1e-3 of transformers';
* against the JAX loader on the same files: the same tree, every code,
  scale and plain tensor bit-equal (int8 quantization is bit-equal between
  the packages, tests/test_torch_formats_quant.py), and for Llama the
  logits within the weight-only parity bound of tests/test_torch_llm.py,
  1e-3 of max |logit| (fp32 dequantization, as there);
* FLUX: the int8 load bit-equal to ``quantize_model`` of the tree held in
  memory, and extra, missing and renamed keys raise.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import sdnq_tpu as J
import sdnq_tpu_torch as T
from sdnq_tpu import io as jio
from sdnq_tpu.models import llm as jllm
from sdnq_tpu_torch.io import (
    load_clip_text, load_flux, load_llama, load_t5, load_vae,
)
from sdnq_tpu_torch.io import _safetensors as S
from sdnq_tpu_torch.io.hf import CheckpointCoverageError
from sdnq_tpu_torch.io.keymaps import sd_unet_key_map, vae_key_map
from sdnq_tpu_torch.models import (
    DiTConfig, VAE_TINY_CONFIG, clip_encode, dit_forward, generate,
    init_dit, init_vae, llm_forward, t5_encode, vae_decode, vae_encode,
)
from sdnq_tpu_torch.tree import tree_leaves

from test_torch_io import _assert_same_tree, _flat


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CPU = dict(device="cpu")
ALL_PLAIN = dict(modules_to_not_convert=["*"])
INT8_SMALL = dict(weights_dtype="int8", minimum_allowed_numel=1024,
                  minimum_allowed_channel_size=16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _nmse(got, ref):
    got, ref = _np(got), _np(ref)
    return ((got - ref) ** 2).mean() / (ref ** 2).mean()


def _n_q(tree) -> int:
    return sum(isinstance(x, T.QTensor) for x in tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, T.QTensor)))


# ---------------------------------------------------------------------------
# Llama and CLIP (transformers save_pretrained)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    cfg = LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0,
        tie_word_embeddings=False, rms_norm_eps=1e-6)
    model = LlamaForCausalLM(cfg).eval()
    with torch.no_grad():   # the default init is tiny; widen it
        for p in model.parameters():
            if p.ndim >= 2:
                p.mul_(3.0)
    path = tmp_path_factory.mktemp("llama")
    model.save_pretrained(path, safe_serialization=True)
    ids = torch.randint(0, 512, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(ids).logits.float().numpy()
    return str(path), ids, ref


def test_llama_unquantized_parity(llama_ckpt):
    path, ids, ref = llama_ckpt
    params, cfg, _ = load_llama(path, T.QuantConfig(**ALL_PLAIN),
                                dtype=torch.float32, **CPU)
    assert _n_q(params) == 0 and cfg.num_kv_heads == 2
    logits, _ = llm_forward(params, ids, cfg, **CPU)
    assert _rel(logits, ref) < 2e-3


def test_llama_int8_within_threshold_and_equal_to_jax(llama_ckpt):
    path, ids, ref = llama_ckpt
    # fp32 dequantization, as in the parity tests of tests/test_torch_llm.py
    cfg_q = dict(INT8_SMALL, quant_embedding=True, dequant_dtype="float32")
    params, cfg, _ = load_llama(path, T.QuantConfig(**cfg_q),
                                dtype=torch.float32, **CPU)
    assert _n_q(params) > 0
    logits, _ = llm_forward(params, ids, cfg, **CPU)
    assert _nmse(logits, ref) < 1e-3
    jparams, jcfg, _ = jio.load_llama(path, J.QuantConfig(**cfg_q),
                                      dtype=jnp.float32)
    _assert_same_tree(params, jparams)
    jlogits, _ = jllm.llm_forward(jparams, jnp.asarray(ids.numpy()), jcfg)
    assert _rel(logits, jlogits) < 1e-3


def test_llama_generate_runs(llama_ckpt):
    path, ids, _ = llama_ckpt
    params, cfg, _ = load_llama(path, T.QuantConfig(), **CPU)
    toks = generate(params, ids[:, :8], cfg, max_new_tokens=4, **CPU)
    assert toks.shape == (2, 4)


def test_llama_tied_head_and_strict(llama_ckpt, tmp_path):
    """A tied checkpoint gets lm_head from the embedding; a key the map
    does not consume raises, unless ``strict=False``."""
    path, _, _ = llama_ckpt
    sd = S.load_file(os.path.join(path, "model.safetensors"))
    hf = json.loads(open(os.path.join(path, "config.json")).read())
    tied = dict(sd)
    del tied["lm_head.weight"]
    S.save_file(tied, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(
        dict(hf, tie_word_embeddings=True)))
    params, cfg, _ = load_llama(str(tmp_path), **CPU)
    assert cfg.tie_embeddings
    assert params["lm_head"]["weight"] is params["embed_tokens"]["weight"]
    S.save_file(dict(tied, **{"vision.proj.weight": torch.ones(2, 2)}),
                str(tmp_path / "model.safetensors"))
    with pytest.raises(CheckpointCoverageError, match="vision.proj.weight"):
        load_llama(str(tmp_path), **CPU)
    params, _, _ = load_llama(str(tmp_path), strict=False, **CPU)
    assert "vision" not in params


def test_chip_smoke_llama_writer_matches_transformers(llama_ckpt):
    """The keys and config fields phase 4i writes for Llama-3-8B are those
    of transformers' ``save_pretrained``."""
    path, _, _ = llama_ckpt
    params, cfg, _ = load_llama(path, T.QuantConfig(**ALL_PLAIN), **CPU)
    header, _ = S.read_header(os.path.join(path, "model.safetensors"))
    assert set(CS.transformers_llama_state(params)) == set(header)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    ours = CS.llama_hf_config(cfg)
    for key in ("vocab_size", "hidden_size", "intermediate_size",
                "num_hidden_layers", "num_attention_heads",
                "num_key_value_heads", "head_dim", "rope_theta",
                "tie_word_embeddings", "model_type"):
        assert ours[key] == hf[key], key


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    from transformers import CLIPTextConfig, CLIPTextModel
    torch.manual_seed(0)
    cfg = CLIPTextConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=32, hidden_act="quick_gelu",
        bos_token_id=254, eos_token_id=255, pad_token_id=0)
    model = CLIPTextModel(cfg).eval()
    path = tmp_path_factory.mktemp("clip")
    model.save_pretrained(path, safe_serialization=True)
    ids = torch.randint(1, 250, (2, 32),
                        generator=torch.Generator().manual_seed(2))
    ids[:, -1] = cfg.eos_token_id
    with torch.no_grad():
        ref = model(ids).last_hidden_state.float().numpy()
    return str(path), ids, ref


def test_clip_unquantized_parity(clip_ckpt):
    path, ids, ref = clip_ckpt
    params, cfg, _ = load_clip_text(path, T.QuantConfig(**ALL_PLAIN),
                                    dtype=torch.float32, **CPU)
    h, _ = clip_encode(params, ids, cfg, **CPU)
    assert _rel(h, ref) < 2e-3


def test_clip_int8_within_threshold_and_equal_to_jax(clip_ckpt):
    path, ids, ref = clip_ckpt
    params, cfg, _ = load_clip_text(path, T.QuantConfig(**INT8_SMALL),
                                    dtype=torch.float32, **CPU)
    assert _n_q(params) > 0
    h, _ = clip_encode(params, ids, cfg, **CPU)
    assert _nmse(h, ref) < 1e-3
    jparams, _, _ = jio.load_clip_text(path, J.QuantConfig(**INT8_SMALL),
                                       dtype=jnp.float32)
    _assert_same_tree(params, jparams)


# ---------------------------------------------------------------------------
# T5 (transformers) and the VAE (diffusers' layout)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def t5_ckpt(tmp_path_factory):
    from transformers import T5Config, T5EncoderModel
    torch.manual_seed(0)
    cfg = T5Config(
        vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=32,
        feed_forward_proj="gated-gelu", dropout_rate=0.0,
        decoder_start_token_id=0)
    model = T5EncoderModel(cfg).eval()
    path = tmp_path_factory.mktemp("t5")
    model.save_pretrained(path, safe_serialization=True)
    ids = torch.randint(1, 250, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(ids).last_hidden_state.float().numpy()
    return str(path), ids, ref


def test_t5_unquantized_parity(t5_ckpt):
    path, ids, ref = t5_ckpt
    params, cfg, _ = load_t5(path, T.QuantConfig(**ALL_PLAIN),
                             dtype=torch.float32, **CPU)
    assert cfg.num_layers == 2 and cfg.head_dim == 16
    assert _rel(t5_encode(params, ids, cfg, **CPU), ref) < 2e-3


def test_t5_int8_within_threshold_and_equal_to_jax(t5_ckpt):
    path, ids, ref = t5_ckpt
    params, cfg, _ = load_t5(path, T.QuantConfig(**INT8_SMALL),
                             dtype=torch.float32, **CPU)
    assert _n_q(params) > 0
    assert _nmse(t5_encode(params, ids, cfg, **CPU), ref) < 1e-3
    jparams, _, _ = jio.load_t5(path, J.QuantConfig(**INT8_SMALL),
                                dtype=jnp.float32)
    _assert_same_tree(params, jparams)


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A checkpoint in diffusers' AutoencoderKL layout from the port's own
    seeded tree: the names are the tree's but for the attention blocks'
    ``to_out.0``, plus the two 1x1 quant convs."""
    cfg = VAE_TINY_CONFIG
    params = init_vae(cfg, generator=torch.Generator().manual_seed(0),
                      **CPU)
    lat = cfg.latent_channels
    g = torch.Generator().manual_seed(5)
    state = {k.replace(".to_out.", ".to_out.0."): v
             for k, v in _flat(params).items()}
    for name, ch in (("quant_conv", 2 * lat), ("post_quant_conv", lat)):
        state[f"{name}.weight"] = (
            0.3 * torch.randn(ch, ch, 1, 1, generator=g)
            + torch.eye(ch)[..., None, None])
        state[f"{name}.bias"] = torch.zeros(ch)
    path = tmp_path_factory.mktemp("vae")
    S.save_file(state, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "block_out_channels": [cfg.base_channels * m
                               for m in cfg.channel_mults],
        "latent_channels": cfg.latent_channels,
        "layers_per_block": cfg.layers_per_block,
        "out_channels": cfg.out_channels,
        "norm_num_groups": cfg.norm_groups,
        "scaling_factor": cfg.scaling_factor}))
    return str(path), params


def test_vae_and_unet_key_maps():
    assert vae_key_map("decoder.mid_block.attentions.0.to_out.0.weight") \
        == "decoder.mid_block.attentions.0.to_out.weight"
    assert vae_key_map("decoder.mid_block.attentions.0.query.weight") \
        == "decoder.mid_block.attentions.0.to_q.weight"
    assert vae_key_map("encoder.conv_in.weight") == "encoder.conv_in.weight"
    assert vae_key_map("decoder.norm1.running_mean") is None
    assert sd_unet_key_map("down_blocks.0.resnets.0.conv1.weight") \
        == "down_blocks.0.resnets.0.conv1.weight"
    assert sd_unet_key_map("mid_block.norm.num_batches_tracked") is None


def test_vae_checkpoint_roundtrip(vae_ckpt):
    path, src = vae_ckpt
    params, cfg, _ = load_vae(path, T.QuantConfig(**ALL_PLAIN),
                              dtype=torch.float32, **CPU)
    assert cfg.base_channels == VAE_TINY_CONFIG.base_channels
    assert "quant_conv" in params and "post_quant_conv" in params
    assert torch.equal(
        params["decoder"]["mid_block"]["attentions"][0]["to_q"]["weight"],
        src["decoder"]["mid_block"]["attentions"][0]["to_q"]["weight"])
    g = torch.Generator().manual_seed(1)
    z = torch.randn(1, 8, 8, cfg.latent_channels, generator=g)
    img = vae_decode(params, z, cfg, **CPU)
    assert img.shape == (1, 16, 16, 3) and torch.isfinite(img).all()
    bare = {k: v for k, v in params.items() if k != "post_quant_conv"}
    assert (img - vae_decode(bare, z, cfg, **CPU)).abs().max() > 1e-5
    lat = vae_encode(params, torch.randn(1, 16, 16, 3, generator=g), cfg,
                     **CPU)
    assert lat.shape == (1, 8, 8, cfg.latent_channels)
    jparams, _, _ = jio.load_vae(path, J.QuantConfig(**ALL_PLAIN),
                                 dtype=jnp.float32)
    _assert_same_tree(params, jparams)


# ---------------------------------------------------------------------------
# FLUX (diffusers' FluxTransformer2DModel layout)
# ---------------------------------------------------------------------------

FLUX_CFG = DiTConfig(in_channels=4, hidden_size=64, num_heads=2,
                     depth_double=2, depth_single=2, txt_dim=32, vec_dim=16,
                     axes_dims=(8, 12, 12), guidance_embed=True)


@pytest.fixture(scope="module")
def flux_ckpt(tmp_path_factory):
    """The port's seeded tree written in diffusers' layout over two shards
    and an index by ``chip_smoke.py``'s writer, which phase 4i runs at
    FLUX.1-dev's width."""
    params = init_dit(FLUX_CFG, generator=torch.Generator().manual_seed(3),
                      **CPU)
    path = tmp_path_factory.mktemp("flux")
    CS.write_sharded(CS.diffusers_flux_state(params, FLUX_CFG), str(path))
    assert len(S.checkpoint_files(str(path))) == 2
    (path / "config.json").write_text(json.dumps(
        CS.flux_hf_config(FLUX_CFG)))
    return str(path), params


def _flux_forward(params, cfg):
    g = torch.Generator().manual_seed(0)
    img = torch.randn(1, 16, cfg.in_channels, generator=g)
    txt = torch.randn(1, 8, cfg.txt_dim, generator=g)
    t = torch.full((1,), 0.4)
    pooled = torch.randn(1, cfg.vec_dim, generator=g)
    return dit_forward(params, img, txt, t, pooled, cfg, guidance=t, **CPU)


def test_flux_keymap_roundtrip_unquantized(flux_ckpt):
    path, orig = flux_ckpt
    qp, cfg, _ = load_flux(path, T.QuantConfig(**ALL_PLAIN),
                           dtype=torch.float32, **CPU)
    assert cfg == FLUX_CFG and _n_q(qp) == 0
    # fused back exactly: the same tensors as the tree that was written
    assert set(_flat(qp)) == set(_flat(orig))
    for k, v in _flat(orig).items():
        assert torch.equal(_flat(qp)[k], v), k
    ref = _flux_forward(orig, FLUX_CFG)
    assert torch.equal(_flux_forward(qp, cfg), ref)


def test_flux_int8_equals_quantize_model_and_jax(flux_ckpt):
    path, orig = flux_ckpt
    qc = dict(weights_dtype="int8", use_quantized_matmul=True,
              minimum_allowed_numel=1024, minimum_allowed_channel_size=16)
    qp, cfg, _ = load_flux(path, T.QuantConfig(**qc), **CPU)
    direct, _ = T.quantize_model(_to_bf16(orig), T.QuantConfig(**qc),
                                 arch="FluxTransformer2DModel", **CPU)
    assert _n_q(qp) > 0
    _assert_same_tree(qp, direct)
    assert torch.equal(_flux_forward(qp, cfg), _flux_forward(direct, cfg))
    jqp, _, _ = jio.load_flux(path, J.QuantConfig(**qc))
    _assert_same_tree(qp, jqp)


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_bf16(v) for v in tree]
    return tree.to(torch.bfloat16)


def _perturbed(src, dst, mutate):
    """A copy of the checkpoint with its state dict run through
    ``mutate``, in one file."""
    sd = {}
    for name in S.checkpoint_files(src):
        sd.update(S.load_file(name))
    S.save_file(mutate(sd), os.path.join(dst, "model.safetensors"))
    with open(os.path.join(src, "config.json")) as f:
        cfg = f.read()
    with open(os.path.join(dst, "config.json"), "w") as f:
        f.write(cfg)
    return str(dst)


def test_flux_loader_rejects_extra_key(flux_ckpt, tmp_path):
    path, _ = flux_ckpt
    bad = _perturbed(path, tmp_path, lambda sd: {
        **sd, "transformer_blocks.0.attn.to_q_new.weight": torch.zeros(4, 4)})
    with pytest.raises(CheckpointCoverageError, match="not consumed"):
        load_flux(bad, T.QuantConfig(**ALL_PLAIN), **CPU)


def test_flux_loader_rejects_missing_key(flux_ckpt, tmp_path):
    path, _ = flux_ckpt

    def drop(sd):
        del sd["transformer_blocks.0.attn.to_k.weight"]
        return sd
    bad = _perturbed(path, tmp_path, drop)
    # the fuse of q / k / v finds no k: loudly, never a silent drop
    with pytest.raises((CheckpointCoverageError, KeyError)):
        load_flux(bad, T.QuantConfig(**ALL_PLAIN), **CPU)


def test_flux_loader_rejects_renamed_key(flux_ckpt, tmp_path):
    path, _ = flux_ckpt

    def rename(sd):
        sd["transformer_blocks.0.attn.query.weight"] = sd.pop(
            "transformer_blocks.0.attn.to_q.weight")
        return sd
    bad = _perturbed(path, tmp_path, rename)
    with pytest.raises(CheckpointCoverageError, match="attn.query"):
        load_flux(bad, T.QuantConfig(**ALL_PLAIN), **CPU)


def test_flux_loader_non_strict_mode(flux_ckpt, tmp_path):
    path, _ = flux_ckpt
    bad = _perturbed(path, tmp_path, lambda sd: {
        **sd, "some.extra.stat": torch.zeros(2)})
    qp, _, _ = load_flux(bad, T.QuantConfig(**ALL_PLAIN), strict=False,
                         **CPU)
    assert "transformer_blocks" in qp and "some" not in qp


def test_coverage_uses_no_storage(monkeypatch, flux_ckpt):
    """The structure the loaders check against is the init on the meta
    device: nothing is drawn."""
    from sdnq_tpu_torch.io import keymaps
    seen = []
    real = keymaps._structure

    def spy(init, cfg):
        tree = real(init, cfg)
        seen.extend(t.device.type for t in tree_leaves(tree))
        return tree
    monkeypatch.setattr(keymaps, "_structure", spy)
    load_flux(flux_ckpt[0], T.QuantConfig(**ALL_PLAIN), **CPU)
    assert seen and set(seen) == {"meta"}
