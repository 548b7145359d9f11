# Launch helpers and CLIs of the PyTorch port: the sampler engine's
# scale-out mesh (mesh.py), the sample / serve_engine / monitor CLIs and
# the LLM server (serve.py: BatchedServer, continuous batching with
# MCMC token sampling).  The LLM meshes and the trainer wait for later
# slices (ROADMAP.md queue 1, item 10).
