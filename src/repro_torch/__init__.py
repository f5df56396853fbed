"""PyTorch/CUDA port of the WARP engine (``src/repro`` is the JAX
reference it is held against).

Entry points run on the card by default: ``Retriever.from_index`` /
``from_store`` and ``RetrievalServer`` take ``device=None`` as "cuda" and
raise when CUDA is absent; pass ``device="cpu"`` to run on the CPU. The
package imports ``torch`` and ``numpy`` only — never JAX, never ``repro``.
"""
