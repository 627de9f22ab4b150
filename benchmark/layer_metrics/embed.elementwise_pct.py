"""``embed.elementwise_pct``: the share of the replayed ticks' kernel time
spent outside the matrix products, the work that ROADMAP Queue 2 item
17 would fuse (LayerNorm, bias adds, GELU, softmax, the bf16 casts, the
residual adds, and the GroupBy and Reduce after the ViT); copies and
memsets (the slot's upload) count on neither side. The ViT's
products (``vit.gemm``, the bf16 projections and MLP, and
``vit.attn_products``, the float32 attention) are cuBLAS launches; the
device trace keeps kernel names and no ranges, so a launch counts as a
product by its name (``PRODUCTS``, a name holding any of them) and the
rest is the elementwise share. The ViT launches nothing else that holds
these names."""

#: parts of the names of cuBLAS's matrix-product kernels on an H100:
#: ``nvjet_*`` (cuBLASLt's bf16 GEMMs), ``sm80_xmma_gemm_*`` and
#: ``sm90_xmma_gemm_*`` (float32 batched products), ``*gemm*`` of other
#: generations, ``cutlass`` kernels, and cuBLAS's split-K reduction
PRODUCTS = ("gemm", "nvjet", "xmma", "cutlass", "splitKreduce")
#: the trace's names of copies and memsets
COPIES = ("Memcpy", "Memset")


def read(run):
    sl = run.slice
    if sl is None or not sl.device:
        return None
    kernels = [(b - a, n) for a, b, n in sl.device
               if not n.startswith(COPIES)]
    total = sum(us for us, _n in kernels)
    other = sum(us for us, n in kernels
                if not any(p in n for p in PRODUCTS))
    return 100.0 * other / total if total else None
