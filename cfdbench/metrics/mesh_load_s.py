"""mesh_load_s: host seconds of the port's load of the mesh files
(load_multigrid_mesh, through its .meshcache/ sidecars after the first
run), the benchmark's own span around the call."""


def read(record):
    return record.get("spans", {}).get("mesh_load_s")
