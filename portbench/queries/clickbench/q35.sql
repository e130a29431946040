SELECT "ClientIP", "ClientIP" - 1 AS c1, "ClientIP" - 2 AS c2,
       "ClientIP" - 3 AS c3, COUNT(*) AS c
FROM hits GROUP BY "ClientIP" ORDER BY c DESC LIMIT 10
