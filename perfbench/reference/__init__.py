"""Plain Python and NumPy reference of the packing problem and its
searches; imports nothing of the program."""
