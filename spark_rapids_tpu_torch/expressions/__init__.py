"""Expressions of the port (a subset of the JAX package's)."""

from .arithmetic import (Abs, Add, BitwiseNot, BitwiseOp,  # noqa: F401
                         Divide, IntegralDivide, Multiply, Pmod, Remainder,
                         Shift, Subtract, UnaryMinus)
from .base import (Alias, BoundReference, EvalContext, Expression,  # noqa: F401
                   Literal, col, lit)
from .boolean import And, Or  # noqa: F401
from .comparison import (EqualNullSafe, EqualTo, GreaterThan,  # noqa: F401
                         GreaterThanOrEqual, In, IsNaN, IsNotNull, IsNull,
                         LessThan, LessThanOrEqual, Not)
from .hashing import Murmur3Hash, XxHash64  # noqa: F401
from .regex import Like, RegexUnsupported, RLike, rlike  # noqa: F401
from .strings import (Ascii, Chr, Concat, Length, Levenshtein,  # noqa: F401
                      Lower, OctetLength, Reverse, Soundex, StringLocate,
                      StringPad, StringPredicate, StringRepeat,
                      StringReplace, StringTrim, Substring, SubstringIndex,
                      Translate, Upper, concat, contains, endswith, length,
                      lower, startswith, substring, upper)
