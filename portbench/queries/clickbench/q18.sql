SELECT "UserID", extract(minute FROM to_timestamp_seconds("EventTime")) AS m,
       "SearchPhrase", COUNT(*) AS c
FROM hits GROUP BY "UserID", m, "SearchPhrase" ORDER BY c DESC LIMIT 10
