"""Key ops: codecs, tile sort, merge levels, boundaries and the sort core."""
