"""The plain reference the benchmark judges the program against: plain
float32 PyTorch that imports nothing of the program."""
