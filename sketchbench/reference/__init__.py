"""The plain reference the check holds the program to."""
