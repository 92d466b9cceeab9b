"""The work behind each roofline, counted from the deck's physics and the
atoms' positions alone, never from the program's slots, capacities or
list sizes, and the H100's peaks it is held to."""
