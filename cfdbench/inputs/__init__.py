"""The benchmark's inputs, in numpy: frozen copies of the port's box level
and of its median-dual tetrahedral level, the hierarchies the
configurations size level by level from either generator, a cell-centred
tetrahedral level (Rodinia cfd's kind of mesh, the harness's own),
frozen copies of the port's RCM renumbering and mesh duplication, a
seeded shuffle of every level's node ids (the order an imported mesh
arrives in), the reference's .dat writer and reader, and make.ensure,
which writes a configuration's mesh files into a fixed cache directory
once. Nothing here imports the port: a change to the port's generators
cannot change the benchmark's meshes.
"""
