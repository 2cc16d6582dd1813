"""Offline index builder CLI.

Counterpart of ``sdag_tpu/pipeline/build_index.py``.  The reference assumes
a prebuilt FAISS index + meta JSONL (``config.py:37-39``); this tool builds
the port's equivalents from a corpus JSONL ({"id":..., "text":...} per
line):

    python -m sdag_tpu_torch.pipeline.build_index corpus.jsonl out_dir \
        [--bm25] [--ranker-checkpoint DIR] [--ranker-arch e5-large-v2]
        [--batch-size 256] [--dtype bfloat16] [--device cuda]

Dense: E5 encode (kernel K3 on CUDA) -> embeddings + manifest.
--bm25: C++ analyzer + packed impact postings instead.  The device defaults
to CUDA and the build raises when CUDA is missing; ``--device cpu`` runs
the plain PyTorch path.  Under torchrun the ranks split the encode batches
(the whole world is the data axis) and rank 0 writes the index.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("corpus_jsonl")
    p.add_argument("out_dir")
    p.add_argument("--bm25", action="store_true",
                   help="build the BM25 postings index instead of dense")
    p.add_argument("--ranker-checkpoint", default="")
    p.add_argument("--ranker-arch", default="tiny",
                   help="tiny | e5-large-v2 (when no checkpoint)")
    p.add_argument("--ranker-model-name", default="intfloat/e5-large-v2")
    p.add_argument("--batch-size", default=256, type=int)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--k1", default=0.9, type=float)
    p.add_argument("--b", default=0.4, type=float)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, cuda:LOCAL_RANK under "
                        "torchrun)")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from sdag_tpu_torch.core.mesh import maybe_init_distributed, rank_device
    dev = rank_device(args.device)
    maybe_init_distributed(dev)
    try:
        _build(args, dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _build(args, dev) -> None:
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    texts, ids = load_corpus_jsonl(args.corpus_jsonl)
    print(f"[build] corpus: {len(texts)} documents")
    t0 = time.time()

    if args.bm25:
        from sdag_tpu_torch.retrieval.sparse import BM25Index
        index = BM25Index.from_texts(texts, ids, k1=args.k1, b=args.b,
                                     device=dev)
        index.save(args.out_dir)
    else:
        import torch

        from sdag_tpu_torch.config import Config
        from sdag_tpu_torch.pipeline.resources import build_encoder
        from sdag_tpu_torch.retrieval.dense import DenseIndex
        cfg = Config()
        cfg.RANKER_CHECKPOINT = args.ranker_checkpoint
        cfg.RANKER_ARCH = args.ranker_arch
        cfg.RANKER_MODEL_NAME = args.ranker_model_name
        encoder = build_encoder(cfg, device=dev)
        dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                 else torch.float32)
        index = DenseIndex.from_texts(texts, ids, encoder,
                                      batch_size=args.batch_size,
                                      dtype=dtype, device=dev)
        index.save(args.out_dir)

    print(f"[build] saved {'bm25' if args.bm25 else 'dense'} index to "
          f"{args.out_dir} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
