"""The benchmark's inputs, in numpy: a frozen copy of the port's box
level, the hierarchies the configurations size level by level, frozen
copies of the port's RCM renumbering and mesh duplication, the reference's
.dat writer and reader, and make.ensure, which writes a configuration's
mesh files into a fixed cache directory once. Nothing here imports the
port: a change to the port's generators cannot change the benchmark's
meshes.
"""
