# The language models of the PyTorch port (the port of repro.models):
# config (ModelConfig), layers (the init rule, norms, RoPE), attention
# (GQA, blockwise and decode attention, the KV cache), blocks and lm (the
# LM module, prefill and decode).  The dense family is ported; the other
# families raise NotImplementedError (ROADMAP.md queue 1 item 10).
