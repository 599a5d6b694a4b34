"""renumber_s: host seconds of the port's renumber layer on the loaded
mesh (mgcfd_tpu_torch.prep.renumber.renumber_hierarchy, as its CLI's
--renumber calls it), the benchmark's own span around the call, outside
mesh_load_s; None where the configuration does not renumber."""


def read(record):
    return record.get("spans", {}).get("renumber_s")
