"""The plain reference that decides ``correct``: PyTorch operations in
float32 with TF32 off. It imports nothing of the program."""
