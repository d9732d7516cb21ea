"""CPU tests of the benchmark; ``-m gpu`` for those that need the card."""
