# The language models of the PyTorch port (the port of repro.models):
# config (ModelConfig), layers (the init rule, norms, RoPE), attention
# (GQA, blockwise and decode attention, the KV cache), moe (top-k routing
# and capacity dispatch), ssm (Mamba-2), blocks and lm (the LM module,
# prefill and decode).  The dense, MoE, SSM and hybrid families are
# ported; the VLM and audio families raise NotImplementedError (ROADMAP.md
# queue 1 item 10).
