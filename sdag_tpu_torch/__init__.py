"""sdag_tpu_torch: the PyTorch/CUDA port of sdag_tpu for NVIDIA Hopper.

Same layout and names as ``sdag_tpu`` so each module's counterpart is easy
to find.  Plain tensor code is PyTorch; the two kernel families on the
poisoning experiment's main path are CUDA C++ for ``sm_90a``
(``csrc/sdag_prefill.cu``, ``csrc/bm25_scan_topk.cu``), built with nvcc at
first use (``_build.py``).  Entry points take a ``device`` that defaults to
``"cuda"`` and raise when CUDA is missing; tests pass ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
