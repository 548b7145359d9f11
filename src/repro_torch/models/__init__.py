# The language models of the PyTorch port (the port of repro.models):
# config (ModelConfig), layers (the init rule, norms, RoPE), attention
# (GQA, blockwise and decode attention, the KV cache), moe (top-k routing
# and capacity dispatch), ssm (Mamba-2), blocks and lm (the LM module,
# prefill, decode and the training loss).  Every family is ported: dense,
# MoE, SSM, hybrid, VLM and audio; under a mesh (distributed.sharding) the
# model code applies the JAX package's sharding constraints.
