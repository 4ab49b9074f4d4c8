"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the work, worked out from the benchmark's plain
reference at the cell's shapes, never from the program."""
