"""``mfu.embed``: the ViT's matrix-product operations that the replayed
ticks' delta rows needed, over the card's busy seconds in their trace
times the card's bf16 dense peak. Each delta row (an insert, a delete,
either half of a move) is one image through the forward: ``vit_flops``
of the configuration's widths, at two operations a multiply-add (the
patch projection and, each block, Q/K/V/O, the attention's two products
and the MLP; LayerNorm, GELU and the pooling left out; 34.94 GFLOP at
ViT-B/16's). The padding rows the Map also forwards count for nothing:
this is the share of the card's peak spent on the work the writes
asked for."""

from benchmark import kernel_counts


def vit_flops(cfg: dict) -> float:
    """Matrix-product operations of one image's forward (a frozen copy of
    the port's ``models.vit.vit_flops``)."""
    n = (int(cfg["img"]) // int(cfg["patch"])) ** 2
    pdim = int(cfg["patch"]) ** 2 * int(cfg["chans"])
    dim, mlp = int(cfg["dim"]), int(cfg["mlp_dim"])
    per_block = 8 * n * dim * dim + 4 * n * n * dim + 4 * n * dim * mlp
    return float(2 * n * pdim * dim + int(cfg["depth"]) * per_block)


def read(run):
    sl = run.slice
    if sl is None or not sl.device:
        return None
    rows = sum(i["rows"] for infos in sl.tick_infos.values()
               for i in infos)
    return (100.0 * rows * vit_flops(run.cell.cfg)
            / (sl.busy_s * kernel_counts.BF16_OPS_PER_S))
