"""The plain reference the correctness check holds the program to: NumPy
and plain PyTorch, importing nothing of the program.  The frozen copies of
the program's plain twins (`orb`, `matcher`, `pose`) carry a `dtype` so
that the control can run them one precision below the configuration's."""
