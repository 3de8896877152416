"""realtime_carriers (carriers, higher): C x the seconds of signal in the
blocks finished in the window / the window's wall seconds.  C or more
keeps up with the band."""


def compute(run):
    if not run.wall_s or not run.blocks:
        return None
    return run.n_carriers * run.blocks * run.block_s / run.wall_s
