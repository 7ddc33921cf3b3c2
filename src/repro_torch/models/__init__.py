"""The language models of the port: configs, layers, the unified decoder
LM and its MoE, Mamba and xLSTM blocks. Mirrors ``repro/models``; plain
torch throughout (the reference has no Pallas kernel here)."""
