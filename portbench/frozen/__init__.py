"""Frozen copies of the repository's input makers, each naming the file
and the commit it was copied from, so that the benchmark's inputs stay
as they were when the benchmark was defined."""
