"""The port's decode loop as a step over device tensors (what a CUDA graph
captures), run eagerly on the CPU: chunked EOS checks against the JAX
Generator's while_loop on the committed qa_ckpt, and the decode attention
against the JAX op in both cache dtypes."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.ops import attention as JA
from sdag_tpu.sdag.generate import Generator as JaxGenerator
from sdag_tpu_torch.models.native_ckpt import load_decoder
from sdag_tpu_torch.models.tokenizer import load_tokenizer
from sdag_tpu_torch.ops import attention as TA
from sdag_tpu_torch.sdag.generate import DecodeBuffers, Generator
from sdag_tpu_torch.sdag.spans import (build_plain_chat_ids,
                                       build_rag_prompt_plan)
from sdag_tpu_torch.utils import prompts
from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query, load_world,
                                           malicious_doc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")
MAX_NEW = 20          # a multiple of neither chunk 3 nor chunk 8

needs_ckpt = pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "params.npz")),
    reason="trained qa_ckpt not present")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """Both engines on qa_ckpt and two padded batches of five prompts
    under a bucket of 8 (three inert pad rows): ISO plans and NO-ISO
    chats, each with the JAX Generator's tokens and lengths."""
    world = load_world(os.path.join(CKPT, "world.json"))
    tok = load_tokenizer(CKPT)
    facts = world.facts_for(world.eval_entities)[5:10]
    others = world.facts_for(world.train_entities)
    plans, plain = [], []
    for i, f in enumerate(facts):
        docs = [fact_doc(g) for g in others[3 * i:3 * i + 3]]
        docs.insert(i % 3, fact_doc(f))
        if i % 2 == 0:
            docs.insert(0, malicious_doc(f, "bodiku", variant=i))
        plans.append(build_rag_prompt_plan(tok, fact_query(f), docs))
        user = prompts.USER_RAG_PROMPT.format(
            query=fact_query(f), docs_text=prompts.render_docs_text(docs))
        plain.append(build_plain_chat_ids(tok, prompts.SYSTEM_PROMPT_RAG,
                                          user))
    jparams, jcfg = jax_load_decoder(CKPT)
    tparams, tcfg = load_decoder(CKPT, device="cpu")
    jgen = JaxGenerator(jparams, jcfg, tok, temperature=0.0, batch_bucket=8)
    tgen = Generator(tparams, tcfg, tok, temperature=0.0, batch_bucket=8,
                     device="cpu")
    batches = {}
    for mode in ("iso", "noiso"):
        ids = [p.input_ids for p in plans] if mode == "iso" else plain
        lp = tgen._pad_len(max(len(x) for x in ids))
        metas = [p.metadata(pad_to=lp) for p in plans] \
            if mode == "iso" else None
        arrays = _batch(tok, ids, metas, lp)
        fn = jgen._get_compiled(8, lp, MAX_NEW, mode == "iso")
        jout, jlen = fn(jgen.params, *[jnp.asarray(a) for a in arrays],
                        jax.random.PRNGKey(0))
        batches[mode] = (arrays, np.asarray(jout), np.asarray(jlen))
    return tparams, tcfg, tok, batches


def _batch(tok, ids, metas, lp, bp=8):
    batch = np.full((bp, lp), tok.pad_token_id, np.int32)
    vl = np.zeros(bp, np.int32)
    doc_id = np.full((bp, lp), -1, np.int32)
    nbr = np.zeros((bp, lp), np.int32)
    sul = np.zeros(bp, np.int32)
    for i, x in enumerate(ids):
        batch[i, :len(x)] = x
        vl[i] = len(x)
        if metas is not None:
            doc_id[i], nbr[i], sul[i] = metas[i]
    return batch, doc_id, nbr, sul, vl


@needs_ckpt
@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("mode", ["iso", "noiso"])
def test_chunked_decode_equals_jax(engines, mode, chunk):
    """Greedy tokens and lengths of the device-state decode step, with the
    EOS check once per chunk of 1, 3 or 8 steps (20 new tokens: the last
    chunk is shorter), equal the JAX while_loop's, which checks before
    every step; pad rows stay empty; a second batch through the same
    buffers gives the same answer."""
    tparams, tcfg, tok, batches = engines
    arrays, jout, jlen = batches[mode]
    gen = Generator(tparams, tcfg, tok, temperature=0.0, batch_bucket=8,
                    device="cpu")
    gen.decode_chunk = chunk
    for _ in range(2):
        tout, tlen = gen._generate(*[torch.from_numpy(a) for a in arrays],
                                   MAX_NEW)
        np.testing.assert_array_equal(tlen.numpy(), jlen)
        np.testing.assert_array_equal(tout.numpy(), jout)
    assert (jlen[5:] == 0).all() and (jlen[:5] > 0).all()
    # the run stopped at the first chunk boundary after every row was done
    steps = int(jlen.max())
    assert gen.stats["decode_steps"] == 2 * min(
        MAX_NEW, -(-steps // chunk) * chunk)
    assert len(gen._live) == 1


@needs_ckpt
def test_eos_reached_before_max_new(engines):
    """The trained model ends some answers early, so the chunked EOS exit
    above is exercised, not only the max_new bound."""
    _tparams, _tcfg, _tok, batches = engines
    for mode in ("iso", "noiso"):
        _arrays, _jout, jlen = batches[mode]
        assert int(jlen[:5].min()) < MAX_NEW


@needs_ckpt
def test_sampled_decode_does_not_depend_on_the_chunk(engines):
    """At temperature > 0 a step inverts the CDF at its row of the chunk's
    uniform numbers; on the CPU generator a chunk of n rows draws the next
    n x B numbers, so one batch's tokens do not depend on the chunk."""
    tparams, tcfg, tok, batches = engines
    arrays, _jout, _jlen = batches["noiso"]
    outs = []
    for chunk in (1, 3, 8):
        gen = Generator(tparams, tcfg, tok, temperature=0.8, top_p=0.95,
                        seed=11, batch_bucket=8, device="cpu")
        gen.decode_chunk = chunk
        outs.append([t.numpy() for t in gen._generate(
            *[torch.from_numpy(a) for a in arrays], MAX_NEW)])
    for out, lengths in outs[1:]:
        np.testing.assert_array_equal(out, outs[0][0])
        np.testing.assert_array_equal(lengths, outs[0][1])


def test_decode_buffers_start_and_step_counts():
    """The prompt's visible slots skip hole tokens and everything past
    valid_len; RoPE base positions count active tokens; pad rows are born
    done; a run replays whole chunks, then the remainder."""
    from sdag_tpu_torch.models.llama import DecoderConfig
    cfg = DecoderConfig.tiny()
    buf = DecodeBuffers(cfg, 3, 8, 10, 4, torch.device("cpu"))
    assert buf.step_counts() == [4, 2]
    assert DecodeBuffers(cfg, 1, 8, 3, 8,
                         torch.device("cpu")).step_counts() == [3]
    assert DecodeBuffers(cfg, 1, 8, 16, 8,
                         torch.device("cpu")).step_counts() == [8]
    doc_id = torch.tensor([[-1, -1, 0, -2, -2, 1, 1, -1]] * 3,
                          dtype=torch.int32)
    vl = torch.tensor([7, 4, 0], dtype=torch.int32)
    buf.start(torch.tensor([5, 6, 7], dtype=torch.int32), doc_id, vl, 0)
    expect = torch.zeros(3, 18, dtype=torch.bool)
    expect[0, [0, 1, 2, 5, 6]] = True
    expect[1, [0, 1, 2]] = True
    assert torch.equal(buf.base_mask, expect)
    assert buf.real_len.tolist() == [5, 3, 0]
    assert buf.done.tolist() == [False, False, True]
    assert int(buf.t) == 0 and (buf.out == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 4])
def test_masked_decode_attention_dtypes_match_jax(dtype, rep):
    """The decode attention over f32 and bf16 caches, GQA groups of 1 and
    4, masked slots, against the JAX op on the same (bf16-rounded)
    inputs: f32 within 1e-5; bf16 within 2e-2 (both round P and the
    output to bf16, the sums in another order)."""
    rng = np.random.default_rng(7 + rep)
    B, Hkv, S, Dh = 3, 2, 72, 64
    q = rng.standard_normal((B, Hkv * rep, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    mask = rng.random((B, S)) < 0.6
    mask[:, 0] = True
    mask[2, 1:] = False                     # a row that sees one slot
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    ref = np.asarray(JA.masked_decode_attention(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)),
        jnp.asarray(mask)).astype(jnp.float32))
    out = TA.masked_decode_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)),
        torch.from_numpy(mask))
    assert out.dtype == td and out.shape == (B, Hkv * rep, Dh)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    # the row that sees one slot returns that slot's value row
    np.testing.assert_allclose(
        out.float().numpy()[2].reshape(Hkv, rep, Dh),
        np.repeat(torch.from_numpy(v).to(td).float().numpy()[2, :, :1],
                  rep, axis=1), atol=tol, rtol=0)
