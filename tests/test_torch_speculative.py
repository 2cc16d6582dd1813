"""Prompt-lookup speculative decoding in the port against the JAX package
on the CPU: the speculative sampling pair (``draft_accept_probs`` equal to
JAX's for the same logits; ``sample_excluding`` an exact CDF inversion of
JAX's renormalised residual distribution; the pair's output distribution
that of ``sample_tokens``), greedy tokens and round statistics of the
Generator equal to the JAX Generator's for D in {1, 4, 7} on the ISO and
NO-ISO paths of the committed qa_ckpt (mixed prompt lengths, EOS), chunked
rounds equal to per-round rounds, and speculation on the int8 cache equal
to plain int8 decode (tests/test_torch_pipeline.py runs the experiment with
all three settings)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.models import llama as JL
from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.ops import sampling as JS
from sdag_tpu.sdag.generate import Generator as JaxGenerator
from sdag_tpu_torch.models import llama as TL
from sdag_tpu_torch.models.native_ckpt import load_decoder
from sdag_tpu_torch.models.tokenizer import load_tokenizer
from sdag_tpu_torch.ops.sampling import (draft_accept_probs,
                                         sample_excluding, sample_tokens)
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.sdag.spans import (build_plain_chat_ids,
                                       build_rag_prompt_plan)
from sdag_tpu_torch.utils import prompts
from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query, load_world,
                                           malicious_doc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")
MAX_NEW = 20

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


# ------------------------------------------------------------- sampling
def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("top_p", [1.0, 0.8])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_draft_accept_probs_equal_jax(top_p, temperature):
    """Per-position acceptance probabilities for the same logits within
    1e-6 (absolute; they lie in [0, 1]); drafts outside the nucleus get
    exactly 0."""
    logits = _logits(0, (3, 4, 50))
    drafts = np.random.default_rng(1).integers(0, 50, (3, 4)).astype(
        np.int32)
    drafts[0, 0] = int(np.argmax(logits[0, 0]))
    drafts[1, 1] = int(np.argmin(logits[1, 1]))
    ref = np.asarray(JS.draft_accept_probs(jnp.asarray(logits),
                                           jnp.asarray(drafts), temperature,
                                           top_p))
    out = draft_accept_probs(torch.from_numpy(logits),
                             torch.from_numpy(drafts), temperature,
                             top_p).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out == 0.0, ref == 0.0)
    if top_p < 1.0:
        assert out[1, 1] == 0.0


def _jax_residual(logits, excl, temperature, top_p):
    """JAX's residual distribution (``sample_excluding``'s categorical
    operand), as (tokens [B, C], probabilities [B, C]) in numpy."""
    lg = jnp.asarray(logits) / temperature
    if top_p >= 1.0:
        col = np.arange(logits.shape[-1])[None, :]
        vals = np.asarray(jnp.where(jnp.asarray(col == excl[:, None]),
                                    -jnp.inf, lg))
        idx = np.broadcast_to(col, vals.shape)
    else:
        vals, idx = JS._nucleus_vals_idx(lg, top_p, 64)
        vals, idx = np.asarray(vals), np.asarray(idx)
        vals = np.where(idx == excl[:, None], -np.inf, vals)
    p = np.exp(vals.astype(np.float64) - vals.max(-1, keepdims=True))
    return idx, p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("top_p", [1.0, 0.8])
def test_sample_excluding_inverts_jax_residual_cdf(top_p):
    """At every uniform u (away from a CDF step by more than 1e-5) the
    port's residual draw is the token where JAX's renormalised residual
    distribution's CDF first exceeds u; the excluded token never comes
    back, and excl == -1 excludes nothing."""
    temperature = 0.9
    logits = _logits(2, (4, 50))
    logits[0, 5] += 4.0                    # a dominant token, excluded
    excl = np.asarray([5, -1, 17, int(np.argmax(logits[3]))], np.int32)
    idx, p = _jax_residual(logits, excl, temperature, top_p)
    cdf = np.cumsum(p, -1)
    grid = np.linspace(0.0, 0.999, 400)
    for u in grid:
        if np.abs(cdf - u).min() < 1e-5:
            continue
        uni = torch.full((4,), u, dtype=torch.float32)
        got = sample_excluding(uni, torch.from_numpy(logits),
                               torch.from_numpy(excl), temperature,
                               top_p).numpy()
        want = idx[np.arange(4), (cdf <= u).sum(-1)]
        np.testing.assert_array_equal(got, want)
        assert got[0] != 5 and got[2] != 17 and got[3] != excl[3]


@pytest.mark.parametrize("top_p", [1.0, 0.8])
@pytest.mark.parametrize("draft", [3, 7])
def test_speculative_sampling_distribution_exact(top_p, draft):
    """The port of the JAX test: accept the prob-1 draft d with p(d), else
    draw from p without d -- the frequencies equal sample_tokens' within
    4 sigma of Monte-Carlo error (sigma ~ 0.008 at 4000 draws)."""
    logits = torch.from_numpy(_logits(0, (1, 12)))
    temperature, n = 0.9, 4000
    p_acc = float(draft_accept_probs(logits, torch.tensor([draft]),
                                     temperature, top_p)[0])
    gen = torch.Generator().manual_seed(1)
    u_acc = torch.rand(n, generator=gen)
    u_res = torch.rand(n, generator=gen)
    res = sample_excluding(u_res, logits.expand(n, 12),
                           torch.full((n,), draft, dtype=torch.int32),
                           temperature, top_p)
    spec = torch.where(u_acc < p_acc, draft, res).numpy()
    ref = sample_tokens(torch.Generator().manual_seed(2),
                        logits.expand(n, 12), temperature, top_p).numpy()
    f_spec = np.bincount(spec, minlength=12) / n
    f_ref = np.bincount(ref, minlength=12) / n
    assert np.abs(f_spec - f_ref).max() < 0.04


# ------------------------------------------------------------ Generator
def _port_cfg(jcfg):
    return TL.DecoderConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_layers=jcfg.n_layers, n_heads=jcfg.n_heads,
        n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
        rope_theta=jcfg.rope_theta, norm_eps=jcfg.norm_eps,
        dtype=torch.float32, tie_embeddings=jcfg.tie_embeddings,
        rope_scaling=jcfg.rope_scaling)


@pytest.fixture(scope="module")
def engines():
    """qa_ckpt (float and int8 trees, both engines) and two padded
    batches of five prompts of mixed lengths under a bucket of 8 (three
    inert pad rows): ISO plans and NO-ISO chats."""
    world = load_world(os.path.join(CKPT, "world.json"))
    tok = load_tokenizer(CKPT)
    facts = world.facts_for(world.eval_entities)[15:20]
    others = world.facts_for(world.train_entities)
    plans, plain = [], []
    for i, f in enumerate(facts):
        docs = [fact_doc(g) for g in others[3 * i:3 * i + 1 + i % 3]]
        docs.insert(i % 2, fact_doc(f))
        if i % 2 == 0:
            docs.insert(0, malicious_doc(f, "bodiku", variant=i))
        plans.append(build_rag_prompt_plan(tok, fact_query(f), docs))
        user = prompts.USER_RAG_PROMPT.format(
            query=fact_query(f), docs_text=prompts.render_docs_text(docs))
        plain.append(build_plain_chat_ids(tok, prompts.SYSTEM_PROMPT_RAG,
                                          user))
    jparams, jcfg = jax_load_decoder(CKPT)
    tparams, tcfg = load_decoder(CKPT, device="cpu")
    jq = JL.quantize_decoder_params_int8(jparams)
    tq = TL.params_from_numpy(jax.tree.map(np.asarray, jq), _port_cfg(jcfg),
                              device="cpu")
    batches = {}
    for mode in ("iso", "noiso"):
        ids = [p.input_ids for p in plans] if mode == "iso" else plain
        lp = Generator._pad_len(max(len(x) for x in ids))
        metas = [p.metadata(pad_to=lp) for p in plans] \
            if mode == "iso" else None
        batches[mode] = (_batch(tok, ids, metas, lp), lp)
    return (jparams, jcfg, tparams, tcfg, jq, tq, tok, batches)


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


def _port_run(gen, arrays, max_new=MAX_NEW):
    out, lengths = gen._generate(*[torch.from_numpy(a) for a in arrays],
                                 max_new)
    return out.numpy(), lengths.numpy()


@needs_ckpt
@pytest.mark.parametrize("mode", ["iso", "noiso"])
@pytest.mark.parametrize("draft", [1, 4, 7])
def test_speculative_greedy_tokens_and_stats_equal_jax(engines, draft, mode):
    """Greedy tokens, lengths, verification rounds and live row-rounds of
    the port's speculative rounds equal the JAX speculative engine's (and
    so, by the JAX package's own tests, the plain greedy decode's); pad
    rows stay empty."""
    jparams, jcfg, tparams, tcfg, _jq, _tq, tok, batches = engines
    arrays, lp = batches[mode]
    jgen = JaxGenerator(jparams, jcfg, tok, temperature=0.0,
                        batch_bucket=8, speculative_draft=draft)
    fn = jgen._get_compiled(8, lp, MAX_NEW, mode == "iso")
    jout, jlen, jrounds, jrr = fn(jgen.params,
                                  *[jnp.asarray(a) for a in arrays],
                                  jax.random.PRNGKey(0))
    gen = Generator(tparams, tcfg, tok, temperature=0.0, batch_bucket=8,
                    speculative_draft=draft, device="cpu")
    out, lengths = _port_run(gen, arrays)
    np.testing.assert_array_equal(lengths, np.asarray(jlen))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert gen.last_spec_rounds == gen.spec_total_rounds == int(jrounds)
    assert gen.spec_total_row_rounds == int(jrr)
    assert gen.spec_total_tokens == int(np.asarray(jlen).sum())
    assert (lengths[5:] == 0).all() and (lengths[:5] > 0).all()
    assert lengths[:5].min() < MAX_NEW          # an answer ended at EOS


@needs_ckpt
def test_speculation_accepts_drafts_on_the_trained_model(engines):
    """The trained model copies answers from its context, so drafts are
    accepted: fewer rounds than tokens."""
    _jp, _jc, tparams, tcfg, _jq, _tq, tok, batches = engines
    gen = Generator(tparams, tcfg, tok, temperature=0.0, batch_bucket=8,
                    speculative_draft=4, device="cpu")
    _port_run(gen, batches["iso"][0])
    assert gen.spec_total_tokens > gen.spec_total_row_rounds > 0


@needs_ckpt
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_chunked_rounds_equal_per_round_rounds(engines, temperature):
    """Rounds checked for "every row done" once per chunk of 1, 3 or 4
    (20 rounds at most: the last chunk is shorter) give the tokens and
    statistics of per-round checks; a round after every row is done
    emits nothing.  Sampled rounds draw a chunk's [rounds, B, G]
    uniforms before it, so the tokens do not depend on the chunk."""
    _jp, _jc, tparams, tcfg, _jq, _tq, tok, batches = engines
    arrays, _lp = batches["noiso"]
    runs = []
    for chunk in (1, 3, 4):
        gen = Generator(tparams, tcfg, tok, temperature=temperature,
                        top_p=0.95, seed=5, batch_bucket=8,
                        speculative_draft=4, device="cpu")
        gen.decode_chunk = chunk
        out, lengths = _port_run(gen, arrays)
        runs.append((out, lengths, gen.spec_total_rounds,
                     gen.spec_total_row_rounds))
        assert gen.stats["decode_steps"] >= gen.spec_total_rounds
    for out, lengths, rounds, rr in runs[1:]:
        np.testing.assert_array_equal(out, runs[0][0])
        np.testing.assert_array_equal(lengths, runs[0][1])
        assert (rounds, rr) == runs[0][2:]


@needs_ckpt
@pytest.mark.parametrize("draft,mode", [(3, "iso"), (7, "noiso")])
def test_speculation_on_int8_cache_equals_plain_int8_decode(engines, draft,
                                                            mode):
    """The JAX package's invariant (tests/test_decoder.py): the window
    quantizes its K/V writes per slot like the step, so greedy speculative
    tokens on the int8 tree and int8 cache equal plain int8 decode's."""
    _jp, _jc, _tp, tcfg, _jq, tq, tok, batches = engines
    arrays, _lp = batches[mode]
    plain = Generator(tq, tcfg, tok, temperature=0.0, batch_bucket=8,
                      kv_cache_dtype="int8", device="cpu")
    spec = Generator(tq, tcfg, tok, temperature=0.0, batch_bucket=8,
                     kv_cache_dtype="int8", speculative_draft=draft,
                     device="cpu")
    a, b = _port_run(plain, arrays), _port_run(spec, arrays)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    assert spec.spec_total_tokens > spec.spec_total_row_rounds


@needs_ckpt
def test_sampled_speculation_is_seeded_and_cold_limit_is_greedy(engines):
    """The port of the JAX test: one seed gives one answer; at a
    vanishing temperature sampled speculation collapses to the greedy
    continuation (acceptance probabilities -> 1 / 0, residual ->
    argmax)."""
    _jp, _jc, tparams, tcfg, _jq, _tq, tok, batches = engines
    arrays, _lp = batches["iso"]

    def run(**kw):
        return _port_run(Generator(tparams, tcfg, tok, batch_bucket=8,
                                   device="cpu", **kw), arrays)
    a = run(temperature=0.7, top_p=0.9, seed=3, speculative_draft=4)
    b = run(temperature=0.7, top_p=0.9, seed=3, speculative_draft=4)
    np.testing.assert_array_equal(a[0], b[0])
    cold = run(temperature=1e-5, seed=3, speculative_draft=4)
    greedy = run(temperature=0.0)
    np.testing.assert_array_equal(cold[0], greedy[0])
    np.testing.assert_array_equal(cold[1], greedy[1])
