"""Training metrics, profiling and the HTML report."""
