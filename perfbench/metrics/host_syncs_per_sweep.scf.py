"""Device-to-host convergence reads per sweep."""


def read(rec):
    return rec.get("host_syncs_per_sweep")
