"""The plain reference the benchmark judges the program against: NumPy
only, nothing of the program (`judge.py` decides `correct`)."""
