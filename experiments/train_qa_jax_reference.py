"""The JAX CPU reference of a short ``train_qa`` run, for the port to hold.

Runs the unmodified JAX ``sdag_tpu.pipeline.train_qa.main`` on the CPU at
the qa_ckpt_v4 recipe (byte tokenizer, d=192, 6 layers, batch 32, seq 768,
nbr_frac 0.25, dup_frac 0.0), warm-started from the committed
``experiments/data/qa_ckpt_v4`` (JAX's PRNG init cannot be reproduced in
torch; the checkpoint gives both packages the same initial weights), for
20 steps with a 2-step warmup and one step per dispatch (``--scan-chunk
1``).  The train step is wrapped only to record each step's loss.

Writes ``OUT/reference.json``: the per-step losses, the per-tensor L2
norms of (final - initial) parameters, the final ``teacher_forced_eval``
dict and the flags.  The trained parameters are written to a temporary
directory and dropped.

    python experiments/train_qa_jax_reference.py \\
        [--out experiments/results/train_qa_jax_cpu]     # ~5 min, 8 cores
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")

# the qa_ckpt_v4 recipe (its native_decoder.json "extra"), cut to 20 steps
FLAGS = ["--steps", "20", "--warmup", "2", "--lr", "3e-4",
         "--batch", "32", "--seq-len", "768", "--entities", "64",
         "--seed", "0", "--d-model", "192", "--layers", "6", "--heads", "6",
         "--kv-heads", "6", "--d-ff", "512", "--k-min", "1", "--k-max", "10",
         "--styled-frac", "0.3", "--dup-frac", "0.0", "--nbr-frac", "0.25",
         "--answer-form", "value", "--tokenizer", "byte", "--eval-every",
         "0", "--eval-n", "32", "--scan-chunk", "1", "--mesh-data", "1",
         "--init-from", INIT]


def update_norms(init_dir: str, final_dir: str) -> dict:
    """L2 norm of (final - initial) for every '/'-joined parameter key."""
    import numpy as np
    a = np.load(os.path.join(init_dir, "params.npz"))
    b = np.load(os.path.join(final_dir, "params.npz"))
    return {k: float(np.linalg.norm(b[k].astype(np.float64)
                                    - a[k].astype(np.float64)))
            for k in sorted(a.files)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(
        REPO, "experiments", "results", "train_qa_jax_cpu"))
    args = p.parse_args(argv)
    os.environ["SDAG_FORCE_PLATFORM"] = "cpu"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(tmp, "jc")
        import jax
        jax.config.update("jax_platforms", "cpu")
        from sdag_tpu.pipeline import train_qa

        losses = []
        made = train_qa.make_sharded_train_step

        def recording_step_factory(*a, **kw):
            init_state, step_fn = made(*a, **kw)

            def step(state, batch):
                state, loss = step_fn(state, batch)
                losses.append(float(loss))
                return state, loss
            return init_state, step

        train_qa.make_sharded_train_step = recording_step_factory
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.time()
        try:
            train_qa.main(FLAGS + ["--out", ckpt])
        finally:
            train_qa.make_sharded_train_step = made
        wall = time.time() - t0
        with open(os.path.join(ckpt, "native_decoder.json")) as fh:
            extra = json.load(fh)["extra"]
        ref = {"flags": FLAGS[:-1] + ["experiments/data/qa_ckpt_v4"],
               "losses": losses,
               "update_norms": update_norms(INIT, ckpt),
               "final_eval": extra["final_eval"],
               "jax": jax.__version__, "platform": "cpu",
               "wall_s": wall}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "reference.json"), "w") as fh:
        json.dump(ref, fh, indent=1)
    print(json.dumps({k: ref[k] for k in ("losses", "final_eval")}))


if __name__ == "__main__":
    main()
