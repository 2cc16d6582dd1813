"""The port's HF checkpoint reader and converters against the JAX package
and the HF libraries the port does not import: tiny Llama and BERT models
built locally (no download), saved with ``save_pretrained`` whole and
sharded.
The port's trees equal ``params_from_numpy`` / ``encoder_params_from_numpy``
of the JAX package's converted trees exactly; prefill logits agree with
JAX's ``prefill(attn_impl="xla")`` within 1e-4 (f32) and with HF's;
embeddings likewise; the safetensors reader and writer agree with
``safetensors.torch`` both ways."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdag_tpu.models import e5 as je5
from sdag_tpu.models import hf_convert as jhf
from sdag_tpu.models import llama as JL
from sdag_tpu_torch.models import e5 as te5
from sdag_tpu_torch.models import hf_convert as thf
from sdag_tpu_torch.models import llama as TL
from sdag_tpu_torch.models.safetensors_io import (open_checkpoint,
                                                  save_safetensors)

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for k in g:
        assert g[k].dtype == w[k].dtype == torch.float32, k
        assert g[k].is_contiguous(), k
        assert torch.equal(g[k], w[k]), k


# ------------------------------------------------------------------ Llama
LLAMAS = {
    "gqa_tied": dict(tie_word_embeddings=True, rope_theta=10000.0),
    "gqa_untied_llama3_rope": dict(
        tie_word_embeddings=False, rope_theta=500000.0,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}),
}


def _llama(name, seed=0):
    from transformers import LlamaConfig, LlamaForCausalLM
    hf_cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, attn_implementation="eager",
        **LLAMAS[name])
    torch.manual_seed(seed)
    return LlamaForCausalLM(hf_cfg).eval()


def _save(model, path, sharded):
    kw = {"max_shard_size": "40KB"} if sharded else {}
    model.save_pretrained(str(path), safe_serialization=True, **kw)
    index = os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    assert index == sharded
    return str(path)


def _jax_llama_tree(model, hf_cfg):
    jcfg = jhf.decoder_config_from_hf(hf_cfg)
    jparams = jhf.convert_llama_state_dict(model.state_dict(), jcfg)
    return jparams, jcfg


@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "sharded"])
@pytest.mark.parametrize("name", sorted(LLAMAS))
def test_llama_tree_and_logits_match_jax_and_hf(tmp_path, name, sharded):
    model = _llama(name)
    path = _save(model, tmp_path, sharded)
    params, cfg = thf.load_decoder_checkpoint(path, device="cpu")
    jparams, jcfg = _jax_llama_tree(model, model.config)
    for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "rope_theta", "norm_eps",
                  "tie_embeddings", "rope_scaling"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.dtype == torch.float32
    _assert_trees_equal(params, TL.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    assert ("lm_head" in params) == (name == "gqa_untied_llama3_rope")

    ids = (np.arange(1, 97, dtype=np.int32).reshape(1, 96) * 7) % 250
    jlog, _ = JL.prefill(jparams, jcfg, jnp.asarray(ids), with_cache=False,
                         attn_impl="xla")
    tlog, _ = TL.prefill(params, cfg, torch.from_numpy(ids),
                         with_cache=False)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids).long()).logits.numpy()
    np.testing.assert_allclose(tlog.numpy(), hf, atol=2e-3, rtol=1e-3)


def test_bf16_checkpoint_loads_as_its_exact_float32_values(tmp_path):
    """A bf16 checkpoint (as Llama-3.1 ships) converts to float32, every
    value the stored bf16 value exactly, as the JAX converter gives."""
    model = _llama("gqa_untied_llama3_rope", seed=4).to(torch.bfloat16)
    path = _save(model, tmp_path, sharded=True)
    params, cfg = thf.load_decoder_checkpoint(path, device="cpu")
    jparams, _ = _jax_llama_tree(model, model.config)
    _assert_trees_equal(params, TL.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    sd = model.state_dict()
    assert torch.equal(params["layers"][1]["mlp"]["down"],
                       sd["model.layers.1.mlp.down_proj.weight"].float().T)


def test_untied_checkpoint_without_lm_head_falls_back_to_embedding():
    model = _llama("gqa_untied_llama3_rope", seed=2)
    sd = {k: v for k, v in model.state_dict().items()
          if k != "lm_head.weight"}
    cfg = thf.decoder_config_from_hf(model.config)
    params = thf.convert_llama_state_dict(sd, cfg, device="cpu")
    jparams = jhf.convert_llama_state_dict(
        sd, jhf.decoder_config_from_hf(model.config))
    _assert_trees_equal(params, TL.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    assert torch.equal(params["lm_head"], params["embed"].T)


def test_config_json_dict_reads_like_the_config_object(tmp_path):
    model = _llama("gqa_untied_llama3_rope")
    model.config.save_pretrained(str(tmp_path))
    from_file = thf.decoder_config_from_hf(thf.read_hf_config(str(tmp_path)))
    assert from_file == thf.decoder_config_from_hf(model.config)
    assert from_file.rope_scaling == (8.0, 1.0, 4.0, 64)
    # defaults of the JAX reader for keys a config.json may leave out
    bare = thf.decoder_config_from_hf({
        "vocab_size": 10, "hidden_size": 8, "num_hidden_layers": 1,
        "num_attention_heads": 2, "intermediate_size": 16})
    assert (bare.n_kv_heads, bare.rope_theta, bare.norm_eps,
            bare.tie_embeddings, bare.rope_scaling) == (2, 10000.0, 1e-5,
                                                        False, None)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_a_missing_or_misshapen_tensor_raises_naming_it(tmp_path, fault):
    model = _llama("gqa_tied")
    sd = dict(model.state_dict())
    key = "model.layers.1.self_attn.k_proj.weight"
    if fault == "missing":
        del sd[key]
    else:
        sd[key] = sd[key][:-1]
    cfg = thf.decoder_config_from_hf(model.config)
    with pytest.raises((KeyError, ValueError), match=key.replace(".", r"\.")):
        thf.convert_llama_state_dict(sd, cfg, device="cpu")


def test_a_dir_without_config_json_raises_naming_it(tmp_path):
    save_safetensors({"x": torch.zeros(2)}, str(tmp_path /
                                                 "model.safetensors"))
    with pytest.raises(FileNotFoundError, match="config.json"):
        thf.load_decoder_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="config.json"):
        thf.load_encoder_checkpoint(str(tmp_path), device="cpu")


# ------------------------------------------------------------------- BERT
def _bert(kind, seed=0):
    from transformers import BertConfig, BertForMaskedLM, BertModel
    hf_cfg = BertConfig(
        vocab_size=200, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, attn_implementation="eager")
    torch.manual_seed(seed)
    cls = BertModel if kind == "bert_model" else BertForMaskedLM
    model = cls(hf_cfg).eval()
    base = model if kind == "bert_model" else model.bert
    return model, base


@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "sharded"])
@pytest.mark.parametrize("kind", ["bert_model", "bert_prefixed"])
def test_bert_tree_and_embeddings_match_jax_and_hf(tmp_path, kind,
                                                   sharded):
    model, base = _bert(kind)
    path = _save(model, tmp_path, sharded)
    with open_checkpoint(path, device="cpu") as ck:
        assert (thf.bert_prefix(ck) == "bert.") == (kind == "bert_prefixed")
    params, cfg = thf.load_encoder_checkpoint(path, device="cpu")
    jcfg = jhf.encoder_config_from_hf(base.config)
    jparams = jhf.convert_bert_state_dict(base.state_dict(), jcfg)
    assert cfg == te5.EncoderConfig(**{
        f: getattr(jcfg, f) for f in ("vocab_size", "d_model", "n_layers",
                                      "n_heads", "d_ff", "max_position",
                                      "norm_eps")})
    _assert_trees_equal(params, te5.encoder_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))

    rng = np.random.default_rng(1)
    ids = rng.integers(1, 200, size=(3, 16)).astype(np.int32)
    mask = np.zeros((3, 16), np.int32)
    for i, n in enumerate([16, 5, 1]):
        mask[i, :n] = 1
    ref = np.asarray(je5.encoder_forward(jparams, jcfg, ids, mask))
    got = te5.encoder_forward(params, cfg, torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    with torch.no_grad():
        hidden = base(input_ids=torch.from_numpy(ids).long(),
                      attention_mask=torch.from_numpy(mask).long()
                      ).last_hidden_state.numpy()
    m = mask[..., None].astype(np.float32)
    hf = (hidden * m).sum(1) / m.sum(1)
    hf = hf / np.linalg.norm(hf, axis=-1, keepdims=True)
    np.testing.assert_allclose(got, hf, atol=2e-4, rtol=1e-3)


# ------------------------------------------------------------ safetensors
DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8]


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        def make(*shape):
            return torch.randint(-128, 128, shape, generator=g,
                                 dtype=torch.int8)
    else:
        def make(*shape):
            return torch.randn(shape, generator=g).to(dtype)
    return {"a.weight": make(7, 5), "b": make(3), "c.scalar": make(),
            "d.empty": make(0, 4), "e": make(2, 3, 4)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_reads_what_safetensors_writes(tmp_path, dtype):
    ts = _tensors(dtype)
    mixed = dict(ts, f32_beside=torch.arange(6, dtype=torch.float32))
    safetensors_torch.save_file(mixed, str(tmp_path / "model.safetensors"),
                                metadata={"format": "pt"})
    with open_checkpoint(str(tmp_path), device="cpu") as ck:
        assert sorted(ck) == sorted(mixed)
        for k, v in mixed.items():
            got = ck[k]
            assert got.dtype == v.dtype and got.shape == v.shape, k
            assert torch.equal(got, v), k


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_safetensors_reads_what_the_writer_writes(tmp_path, dtype):
    ts = _tensors(dtype, seed=1)
    ts["odd"] = torch.arange(3, dtype=torch.int8)   # breaks alignment
    path = str(tmp_path / "x.safetensors")
    n = save_safetensors(ts, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    back = safetensors_torch.load_file(path)
    assert sorted(back) == sorted(ts)
    for k, v in ts.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_sharded_index_and_unsupported_dtype(tmp_path):
    a = {"x": torch.randn(4, 4).to(torch.bfloat16)}
    b = {"y": torch.randn(3), "z": torch.zeros(2, dtype=torch.float64)}
    save_safetensors(a, str(tmp_path / "s1.safetensors"))
    safetensors_torch.save_file(b, str(tmp_path / "s2.safetensors"))
    with open(tmp_path / "model.safetensors.index.json", "w") as fh:
        json.dump({"metadata": {}, "weight_map": {
            "x": "s1.safetensors", "y": "s2.safetensors",
            "z": "s2.safetensors"}}, fh)
    with open_checkpoint(str(tmp_path), device="cpu") as ck:
        assert torch.equal(ck["x"], a["x"]) and torch.equal(ck["y"], b["y"])
        with pytest.raises(ValueError, match="F64"):
            ck["z"]


@pytest.mark.parametrize("kind", ["llama", "bert"])
def test_chip_smoke_checkpoint_writer_and_bit_check(tmp_path, kind):
    """Phase 9's library-free checkpoint writer and its bit-equality check
    at a tiny width on the CPU: the written dir loads through the port
    (and through transformers) and every leaf matches its regenerated
    tensor; a leaf changed in one element is caught."""
    import chip_smoke
    if kind == "llama":
        cfg = TL.DecoderConfig(vocab_size=96, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=48,
                               tie_embeddings=False)
        specs, dtype = chip_smoke.llama_hf_specs(cfg), torch.bfloat16
        hf = {"model_type": "llama", "vocab_size": 96, "hidden_size": 32,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 48,
              "tie_word_embeddings": False, "rms_norm_eps": 1e-5}
    else:
        cfg = te5.EncoderConfig(vocab_size=50, d_model=32, n_layers=2,
                                n_heads=4, d_ff=48, max_position=16)
        specs, dtype = chip_smoke.bert_hf_specs(cfg), torch.float32
        hf = {"model_type": "bert", "vocab_size": 50, "hidden_size": 32,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 48, "max_position_embeddings": 16,
              "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    path = str(tmp_path)
    nbytes, _ = chip_smoke.write_hf_checkpoint(
        path, specs, dtype, "cpu", shards=3 if kind == "llama" else 1,
        seed=40)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    if kind == "llama":
        params, _ = thf.load_decoder_checkpoint(path, device="cpu")
        model = transformers.AutoModelForCausalLM.from_pretrained(path)
    else:
        params, _ = thf.load_encoder_checkpoint(path, device="cpu")
        model = transformers.AutoModel.from_pretrained(path)
    sd = model.state_dict()
    for i, (name, shape, std) in enumerate(specs):     # HF's names, shapes
        want = chip_smoke._draw(40 + i, shape, std, dtype, "cpu")
        assert torch.equal(sd[name].float(), want.float()), name
    esize = torch.finfo(dtype).bits // 8
    assert nbytes > esize * sum(sd[name].numel() for name, _s, _d in specs)
    assert not chip_smoke._tree_bit_equal(params, specs, dtype, "cpu", 40,
                                          llama=kind == "llama")
    leaf, _ = chip_smoke._tree_leaf(params, specs[-2][0],
                                    llama=kind == "llama")
    leaf.view(-1)[3] += 1.0
    assert chip_smoke._tree_bit_equal(params, specs, dtype, "cpu", 40,
                                      llama=kind == "llama") == [specs[-2][0]]
