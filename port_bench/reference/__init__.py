"""The benchmark's plain reference: plain PyTorch, float32 with TF32 off.
Imports nothing of the program (checked by port_bench.guards)."""
