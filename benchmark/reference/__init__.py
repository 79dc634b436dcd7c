"""The plain references the check holds the program against."""
