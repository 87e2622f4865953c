"""Expressions of the port (a subset of the JAX package's), exported
under the JAX names."""

from .arithmetic import (Abs, Add, BitwiseNot, BitwiseOp,  # noqa: F401
                         Divide, IntegralDivide, Multiply, Pmod, Remainder,
                         Shift, Subtract, UnaryMinus)
from .base import (Alias, BoundReference, EvalContext, Expression,  # noqa: F401
                   Literal, col, lit)
from .boolean import And, Or  # noqa: F401
from .cast import Cast, cast_supported  # noqa: F401
from .collections import (AggregateArray, ArrayContains,  # noqa: F401
                          ArrayDistinct, ArrayExcept, ArrayIntersect,
                          ArrayMax, ArrayMin, ArrayPosition, ArrayRemove,
                          ArrayRepeat, ArraySlice, ArrayUnion, ArraysOverlap,
                          CreateArray, CreateStruct, ElementAt, ExistsArray,
                          FilterArray, Flatten, ForallArray, GetArrayItem,
                          GetMapValue, GetStructField, LambdaVariable,
                          MapContainsKey, MapFilter, MapFromArrays, MapKeys,
                          MapValues, ReplicateRows, Sequence, Size,
                          SortArray, TransformArray, TransformKeys,
                          TransformValues, ZipWith, hof_var)
from .comparison import (EqualNullSafe, EqualTo, GreaterThan,  # noqa: F401
                         GreaterThanOrEqual, In, IsNaN, IsNotNull, IsNull,
                         LessThan, LessThanOrEqual, Not)
from .conditional import CaseWhen, Coalesce, If, LeastGreatest  # noqa: F401
from .json import GetJsonObject, JsonToStructs, json_tuple  # noqa: F401
from .datetime import (AddMonths, DateAddSub, DateDiff,  # noqa: F401
                       DateFormat, DateTimeFormatUnsupported, ExtractDatePart,
                       FromUnixtime, LastDay, MonthsBetween, NextDay,
                       ParseDateTime, TruncDateTime, UnixTimestampConv,
                       UTCTimestampConv, add_months, date_add, date_format,
                       date_sub, date_trunc, datediff, dayofmonth, dayofweek,
                       dayofyear, from_unixtime, hour, minute, month,
                       months_between, next_day, quarter, second, to_date,
                       to_timestamp, trunc, unix_timestamp, weekofyear, year)
from .hashing import Murmur3Hash, XxHash64  # noqa: F401
from .math import (Atan2, FloorCeil, Hypot, Logarithm, NaNvl,  # noqa: F401
                   Pow, RaiseError, Rand, Round, Signum, UnaryMath)
from .regex import (Like, RegexpExtract, RegexpReplace,  # noqa: F401
                    RegexUnsupported, RLike, StringSplit, rlike)
from .strings import (Ascii, Bin, Chr, Concat, ConcatWs,  # noqa: F401
                      Conv, Empty2Null, FindInSet, FormatNumber, Hex,
                      InitCap, Length, Levenshtein, Lower, OctetLength,
                      Reverse, Soundex, StringLocate, StringPad,
                      StringPredicate, StringRepeat, StringReplace,
                      StringToMap, StringTrim, Substring, SubstringIndex, Translate,
                      Upper, concat, contains, endswith, length, lower,
                      startswith, substring, upper)
