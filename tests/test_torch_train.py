"""The port's training step against the JAX package on the CPU: ``lm_loss``
and its per-tensor gradients against ``jax.value_and_grad(lm_loss)`` on
ISO, causal and neighbor-window batches, tied and untied, GQA and not;
the differentiable dense-mask attention against the plain version of K1;
AdamW against ``optax.adamw`` over one and two steps on the same
gradients; the warmup-cosine schedule against optax at every step; a scan
of S steps against S steps; and kernel K1 refusing to run under
autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdag_tpu.models.llama import DecoderConfig as JaxDecoderConfig
from sdag_tpu.models.llama import init_decoder_params as jax_init
from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from sdag_tpu.parallel.train import lm_loss as jax_lm_loss
from sdag_tpu.pipeline.train_qa import sample_batch as jax_sample_batch
from sdag_tpu_torch.core.mesh import make_mesh
from sdag_tpu_torch.models.llama import (DecoderConfig, layer_forward,
                                         params_from_numpy, prefill)
from sdag_tpu_torch.ops.attention import (prefill_dense_mask,
                                          sdag_attention_dense,
                                          sdag_attention_reference,
                                          sdag_prefill_cuda)
from sdag_tpu_torch.parallel.train import (AdamW, _trainable, lm_loss,
                                           make_dummy_batch,
                                           make_sharded_train_scan,
                                           make_sharded_train_step,
                                           warmup_cosine_decay_schedule)
from sdag_tpu_torch.utils.tree import flatten_with_paths

LOSS_RTOL = 1e-5
# a gradient leaf's max abs error over its largest |value| (f32 sums in
# another order; measured ~2e-6)
GRAD_TOL = 1e-4


def _cfgs(tie=True, kv=2):
    kw = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=kv, d_ff=96, tie_embeddings=tie)
    return JaxDecoderConfig(**kw), DecoderConfig(**kw)


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batches():
    """ISO (dummy docs), causal, neighbor windows, and a real synthetic
    QA batch (ISO / causal rows, neighbor windows, holes of padding)."""
    jcfg, cfg = _cfgs()
    iso = {k: v.numpy() for k, v in make_dummy_batch(cfg, 4, 48).items()}
    causal = dict(iso, doc_id=np.full_like(iso["doc_id"], -1),
                  sys_user_len=np.zeros_like(iso["sys_user_len"]))
    nbr = dict(iso, nbr_bits=np.where(iso["doc_id"] == 0, 2, 0)
               .astype(np.int32))
    real = {k: np.asarray(v) for k, v in jax_sample_batch(
        np.random.default_rng(3), JaxByteTokenizer(), None, 4, 768,
        k_min=1, k_max=3, nbr_frac=1.0).items()}
    real["input_ids"] = real["input_ids"] % 256
    real["targets"] = real["targets"] % 256
    return {"iso": iso, "causal": causal, "nbr": nbr, "qa": real}


BATCHES = _batches()


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_lm_loss_and_grads_match_jax(name, tie, kv):
    jcfg, cfg = _cfgs(tie, kv)
    jp = jax_init(jax.random.PRNGKey(0), jcfg)
    jb = {k: jnp.asarray(v) for k, v in BATCHES[name].items()}
    want, jg = jax.value_and_grad(jax_lm_loss)(jp, jcfg, jb)
    params = _trainable(params_from_numpy(jax.tree.map(np.asarray, jp),
                                          cfg, device="cpu"))
    batch = {k: torch.from_numpy(v.copy()) for k, v in
             BATCHES[name].items()}
    loss = lm_loss(params, cfg, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    flat = flatten_with_paths(params)
    grads = torch.autograd.grad(loss, list(flat.values()))
    jflat = _jax_flat(jg)
    assert set(jflat) == set(flat)
    for (k, _), g in zip(flat.items(), grads):
        ref = jflat[k]
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_TOL, (k, err)


@pytest.mark.parametrize("name", ["iso", "nbr", "qa"])
def test_dense_attention_equals_the_plain_k1_version(name):
    """The training path's batched attention against the row-chunked
    plain version of K1 on the same SDAG metadata (GQA, 2 groups)."""
    b = {k: torch.from_numpy(v.copy()) for k, v in BATCHES[name].items()}
    B, L = b["doc_id"].shape
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 4, L, 16, generator=g)
    k = torch.randn(B, 2, L, 16, generator=g)
    v = torch.randn(B, 2, L, 16, generator=g)
    meta = (b["doc_id"], b["nbr_bits"], b["sys_user_len"], b["valid_len"])
    got = sdag_attention_dense(q, k, v, prefill_dense_mask(*meta))
    want = sdag_attention_reference(q, k, v, *meta[:3], valid_len=meta[3])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_xla_and_auto_prefill_agree_on_the_cpu():
    _, cfg = _cfgs()
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1), jcfg))
    params = params_from_numpy(tree, cfg, device="cpu")
    b = {k: torch.from_numpy(v.copy()) for k, v in BATCHES["nbr"].items()}
    kw = dict(doc_id=b["doc_id"], nbr_bits=b["nbr_bits"],
              sys_user_len=b["sys_user_len"], valid_len=b["valid_len"],
              with_cache=False)
    a, _ = prefill(params, cfg, b["input_ids"], attn_impl="xla", **kw)
    c, _ = prefill(params, cfg, b["input_ids"], attn_impl="auto", **kw)
    torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="attn_impl"):
        prefill(params, cfg, b["input_ids"], attn_impl="splash", **kw)


def test_k1_refuses_autograd():
    """K1 has no backward: a call autograd would record raises instead of
    returning an output with no gradient path to wq/wk/wv; under no_grad
    it reaches the launch checks (here: the tensors are not on CUDA)."""
    q = torch.randn(1, 2, 64, 32, requires_grad=True)
    k = torch.randn(1, 2, 64, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        sdag_prefill_cuda(q, k, k, plan=None)
    with torch.no_grad(), pytest.raises(ValueError, match="not on CUDA"):
        sdag_prefill_cuda(q, k, k, plan=None)


def test_layer_forward_rejects_an_unknown_attn_impl():
    _, cfg = _cfgs()
    x = torch.zeros(1, 8, cfg.d_model)
    z = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="attn_impl"):
        layer_forward({}, cfg, x, z, z, z, z[:, 0], z[:, 0] + 8,
                      attn_impl="pallas")


@pytest.mark.parametrize("steps", [1, 2])
def test_adamw_matches_optax(steps):
    """One and two updates on the same gradients (float, and a schedule
    starting at lr 0): parameters within a few f32 ulps of optax's."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((7, 5)).astype(np.float32),
          "b": [rng.standard_normal(5).astype(np.float32)]}
    gs = [{"a": rng.standard_normal((7, 5)).astype(np.float32),
           "b": [rng.standard_normal(5).astype(np.float32) * 1e-3]}
          for _ in range(steps)]
    for lr in (1e-2, "sched"):
        sched_j = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10,
                                                      3e-4)
                   if lr == "sched" else lr)
        sched_t = (warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 3e-4)
                   if lr == "sched" else lr)
        opt = optax.adamw(sched_j, weight_decay=0.01)
        jp = jax.tree.map(jnp.asarray, p0)
        st = opt.init(jp)
        tp = {"a": torch.tensor(p0["a"]), "b": [torch.tensor(p0["b"][0])]}
        ta = AdamW(sched_t, weight_decay=0.01)
        ts = ta.init(tp)
        for g in gs:
            u, st = opt.update(jax.tree.map(jnp.asarray, g), st, jp)
            jp = optax.apply_updates(jp, u)
            ts = ta.update_([torch.tensor(g["a"]), torch.tensor(g["b"][0])],
                            ts, tp)
        assert ts["count"] == steps
        np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tp["b"][0].numpy(),
                                   np.asarray(jp["b"][0]), rtol=1e-6,
                                   atol=1e-7)
        for name, m in (("mu", 0), ("nu", 1)):
            np.testing.assert_allclose(
                ts[name]["a"].numpy(), np.asarray(st[0][m + 1]["a"]),
                rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("args", [(0.0, 1e-3, 300, 3000, 3e-5),
                                  (0.0, 3e-4, 2, 20, 9e-6),
                                  (1e-5, 1e-3, 7, 50, 0.0)])
def test_schedule_matches_optax_at_every_step(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = warmup_cosine_decay_schedule(*args)
    assert got(0) == float(want(0))
    for c in range(args[3] + 5):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(c))


def test_scan_of_s_steps_equals_s_steps():
    _, cfg = _cfgs()
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4), jcfg))
    mesh = make_mesh(data=1, model=1, device="cpu")
    batches = [make_dummy_batch(cfg, 2, 32, num_docs=n) for n in (1, 2, 3)]
    opt = lambda: AdamW(warmup_cosine_decay_schedule(  # noqa: E731
        0.0, 1e-2, 1, 3, 3e-4), weight_decay=0.01)
    init, step = make_sharded_train_step(cfg, mesh, optimizer=opt())
    state = init(params_from_numpy(tree, cfg, device="cpu"))
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(float(loss))
    init_s, scan = make_sharded_train_scan(cfg, mesh, optimizer=opt())
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    state_s, ls = scan(init_s(params_from_numpy(tree, cfg, device="cpu")),
                       stacked)
    assert state_s.step == state.step == 3
    assert ls.tolist() == losses
    for a, b in zip(flatten_with_paths(state.params).values(),
                    flatten_with_paths(state_s.params).values()):
        assert torch.equal(a, b)
