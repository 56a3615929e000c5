"""Traffic generation and metric arithmetic that later changes to the program cannot move."""
