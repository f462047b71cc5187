"""Plain references of the benchmark's configurations, one module each,
named by a configuration's ``reference`` key. Torch only: nothing here
imports the program under test."""
