"""Plain references of what the scheduler must decide, in NumPy alone;
nothing here imports the program."""
