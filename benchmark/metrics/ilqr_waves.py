"""ilqr_waves: the waves of the traced window's last kernel-1 launch, as the
program counts them (``ilqr_fused.WAVES``: the launch's 1024-example tiles
over the clusters the card holds at once, cudaOccupancyMaxActiveClusters of
the launched kernel). A wave takes about as long as one tile, so a launch of
two waves takes about twice one's time. Nothing is read where the program
keeps no such counter or launched no kernel."""


def read(ctx):
    try:
        from dilqr_tpu_torch.ops.cuda import ilqr_fused
    except ImportError:
        return None
    waves = getattr(ilqr_fused, "WAVES", None)
    return float(waves) if waves else None
