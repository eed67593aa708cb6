"""The plain reference the benchmark judges the port against: plain
PyTorch and NumPy that import nothing of the program (`orb.py`: ORB
extraction; `match.py`: Hamming top-2 with the projection window;
`trajectory.py`: the ground truth's alignment and its errors)."""
