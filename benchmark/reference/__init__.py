"""Plain references of the benchmark's cells, independent of the program."""
