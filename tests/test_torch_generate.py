"""Port Generator vs the JAX Generator on the committed qa_ckpt: greedy
tokens equal for ISO and NO-ISO (a partial batch under batch_bucket), and
the samplers checked as the JAX tests check them."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.ops.sampling import top_p_filter as jax_top_p_filter
from sdag_tpu.sdag.generate import Generator as JaxGenerator
from sdag_tpu_torch.models.native_ckpt import load_decoder
from sdag_tpu_torch.models.tokenizer import load_tokenizer
from sdag_tpu_torch.ops.sampling import sample_tokens, top_p_filter
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.sdag.spans import (build_plain_chat_ids,
                                       build_rag_prompt_plan)
from sdag_tpu_torch.utils import prompts
from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query, load_world,
                                           malicious_doc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "params.npz")),
    reason="trained qa_ckpt not present")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it (measured 4.5x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    world = load_world(os.path.join(CKPT, "world.json"))
    tok = load_tokenizer(CKPT)
    facts = world.facts_for(world.eval_entities)[:5]
    others = world.facts_for(world.train_entities)
    plans, plain = [], []
    for i, f in enumerate(facts):
        docs = [fact_doc(g) for g in others[3 * i:3 * i + 3]]
        docs.insert(i % 3, fact_doc(f))
        if i % 2:
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
    return jgen, tgen, plans, plain


def _batch(gen, ids, metas, lp):
    """The padded batch both engines' _run builds (5 rows -> bucket 8)."""
    bp = 8
    batch = np.full((bp, lp), gen.tokenizer.pad_token_id, np.int32)
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


@pytest.mark.parametrize("mode", ["iso", "noiso"])
def test_greedy_tokens_equal_jax(setup, mode):
    jgen, tgen, plans, plain = setup
    max_new = 24
    if mode == "iso":
        ids = [p.input_ids for p in plans]
        lp = tgen._pad_len(max(len(x) for x in ids))
        metas = [p.metadata(pad_to=lp) for p in plans]
    else:
        ids, metas = plain, None
        lp = tgen._pad_len(max(len(x) for x in ids))
    assert lp == jgen._pad_len(max(len(x) for x in ids))
    arrays = _batch(tgen, ids, metas, lp)
    fn = jgen._get_compiled(8, lp, max_new, mode == "iso")
    jout, jlen = fn(jgen.params, *[jnp.asarray(a) for a in arrays],
                    jax.random.PRNGKey(0))
    tout, tlen = tgen._generate(*[torch.from_numpy(a) for a in arrays],
                                max_new)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert (tlen.numpy()[5:] == 0).all()          # bucket pad rows
    assert (tlen.numpy()[:5] > 0).all()


def test_generate_texts_equal_jax(setup):
    """The public calls (padding, bucketing, decoding to text) agree."""
    jgen, tgen, plans, plain = setup
    # 24 new tokens: the JAX engine reuses the functions compiled above
    assert tgen.generate_plans(plans, max_new_tokens=24) == \
        jgen.generate_plans(plans, max_new_tokens=24)
    assert tgen.generate_ids(plain, max_new_tokens=24) == \
        jgen.generate_ids(plain, max_new_tokens=24)


def test_top_p_filter_equals_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    for p in (0.3, 0.7, 0.95, 1.0):
        np.testing.assert_array_equal(
            np.isfinite(top_p_filter(torch.from_numpy(logits), p).numpy()),
            np.isfinite(np.asarray(jax_top_p_filter(jnp.asarray(logits),
                                                    p))))
    small = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    out = top_p_filter(small, 0.7).numpy()
    assert np.isfinite(out[0, :2]).all() and np.isneginf(out[0, 2:]).all()


def test_sample_greedy_and_generator_determinism():
    logits = torch.tensor([[0.0, 5.0, 1.0], [2.0, 2.0, 1.0]])
    assert sample_tokens(None, logits, 0.0).tolist() == [1, 0]  # first max
    a = sample_tokens(torch.Generator().manual_seed(3), logits, 1.0, 0.9)
    b = sample_tokens(torch.Generator().manual_seed(3), logits, 1.0, 0.9)
    assert a.tolist() == b.tolist()


def test_bounded_nucleus_samples_in_distribution():
    """Draws stay inside the exact nucleus, and their frequencies match the
    renormalized nucleus probabilities (chi-square-free bound: 4 sigma)."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((2, 512)).astype(np.float32)
    base[0, 7] += 8.0       # peaked rows: the nucleus fits the top-64
    base[0, 11] += 7.0
    base[1, 3] += 9.0
    base[1, 200] += 8.5
    logits = torch.from_numpy(base)
    keep = np.isfinite(top_p_filter(logits, 0.9).numpy())
    assert keep.sum(1).max() <= 64
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = np.stack([sample_tokens(gen, logits, 1.0, 0.9).numpy()
                      for _ in range(n)])
    for row in range(2):
        assert keep[row, draws[:, row]].all()
        p = np.where(keep[row], np.exp(base[row] - base[row].max()), 0.0)
        p /= p.sum()
        top = int(np.argmax(p))
        freq = float((draws[:, row] == top).mean())
        sigma = np.sqrt(p[top] * (1 - p[top]) / n)
        assert abs(freq - p[top]) < 4 * sigma, (row, freq, p[top])
