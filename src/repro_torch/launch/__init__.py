"""Process groups: the port's counterpart of the JAX package's device
meshes (``launch/mesh.py``)."""
