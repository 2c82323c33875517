"""Host build time per gene of the window's sweeps: the ``stats`` dict's
StageTimer ``host_build`` total (summed over the build threads) over the
genes built, in ms."""


def read(run):
    c = run.counters
    if not c.get("host_build_genes"):
        return None
    return 1e3 * c["host_build_s"] / c["host_build_genes"]
