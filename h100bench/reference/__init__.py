"""The plain reference: GCN and GAT training steps in plain PyTorch, float32
with TF32 off. It imports nothing of the program and works every derived
quantity (edge weights, the sparse structure, dropout masks) out again from
the benchmark's inputs."""
