"""What the benchmark measures against: the card's published peaks, the
work of each kernel counted from shapes, the reduction of a profiler trace.
It imports nothing of the program under test."""
