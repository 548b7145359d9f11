# Launch helpers of the PyTorch port: the sampler engine's scale-out mesh
# (mesh.py).  The CLIs and the LLM meshes wait for later slices
# (ROADMAP.md queue 1, items 9 and 10).
